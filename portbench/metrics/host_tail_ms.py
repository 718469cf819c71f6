"""host_tail_ms: the host's time at the end of a job after the card's last
operation of it: for each ``job:<i>`` span, from the end of the last device
operation that started inside it to the span's end, mean a job. In a
caustic job that is the maps computed on the host after the last copy."""


def read(window):
    tails = []
    for name, start, end in window.spans:
        if not name.startswith("job:"):
            continue
        ends = [e for _, _, s, e in window.events if start <= s < end]
        if ends:
            tails.append(end - max(ends))
    if not tails:
        return None
    return 1e3 * sum(tails) / len(tails)
