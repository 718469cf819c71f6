"""device_idle_share: the share of the traced window in which no kernel,
copy or fill runs on the card."""

from portbench.harness import busy_seconds


def read(window):
    if not window.events or window.window_s <= 0:
        return None
    return 1.0 - busy_seconds(window.events, window.window_s) / window.window_s
