#!/usr/bin/env python3
"""One benchmark cell's traced window with the port's span recorder on.

    python3 span_window.py --workload <cell> --seed <n> --seconds <s> [--out <file.json>]

from the root of a checkout, on a card. Runs the cell as
``portbench/run.py --trace 1`` does (set-up, one warm-up job of each shape,
an untraced window, then the window under ``torch.profiler`` with the
harness's ``source`` and ``job:<i>`` spans) and, around that traced
window, the port's recorder (``raytrace_tpu_torch.utils.profiling``): its
``rt.*`` spans go onto the window's clock beside the harness's, and each
march launch's lane iterations are grouped by the job that launched it.
Prints one JSON line of what the recorder lets the trace say (``--out``
also writes it to a file):

- ``source_host_ms``: host time in ``rt.source`` a job, no sync;
- ``compute_idle_ms``: time a job inside ``rt.compute`` with nothing on the
  card (the card waiting on the port's host code), and its share of all
  the window's idle time (``compute_idle_share``);
- ``march_iters_per_job``: lane iterations a job, each row's count per job
  averaged over the table's rows; ``iters_by_row``, each row's counts per
  job, which repeat exactly while the march is bitwise;
- ``march_ns_per_iter``: the march kernel's device time over the lane
  iterations of the window;
- ``idle_by_span``: the window's idle time by the innermost span around it
  (the program's or the harness's), in ms a job;
- ``breakdown``: the harness's breakdown, its gaps labelled by the program's
  spans too;
- ``tracing_overhead``: the traced window's rays a second over the
  untraced one's, less one;
- ``maps_hidden_share``: the share of the jobs' ``rt.maps`` host time that
  passed before their job's last march kernel ended (the caustic map's
  host maps hidden behind its march), ``maps_hidden_by_row`` the same by
  row; ``late_ranges_per_job``: the pixel ranges a job mapped after its
  last march kernel ended, and ``late_ranges_by_row`` each row's counts;
- ``bins_kernel_share``: the bins' scatters that took the scatter kernel
  (``rt.bins.kernel`` spans) over all the window's scatters (those and
  ``rt.bins.index_add``), None where it has none; ``bins_kernel_by_row``
  the same by row;
- ``redshift_kernel_share``: the emissivity's redshift chains that ran as
  a kernel (``rt.redshift.kernel`` spans) over all of them (those and
  ``rt.redshift.torch``), None where it has none; ``redshift_kernel_by_row``
  the same by row.

A reader of the benchmark's own would take these from the same
recording; this script leaves the benchmark's files as they are.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from bisect import bisect_left
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.metrics.march_ms import is_march  # noqa: E402


def idle_gaps(events, window_s) -> list:
    """The window's stretches with nothing on the card, as sorted (start, end)."""
    edges = [0.0] + [x for iv in harness.busy_intervals(events) for x in iv] + [window_s]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(gaps, spans) -> tuple:
    """The idle time in ``gaps`` by the innermost of ``spans`` (name, start,
    end) around it ("between jobs" outside them all), and by every span
    name around it: one sweep over the edges of both."""
    marks = [(s, 1, k) for k, (_, s, _) in enumerate(spans)]
    marks += [(e, -1, k) for k, (_, _, e) in enumerate(spans)]
    marks += [(s, 2, -1) for s, _ in gaps] + [(e, -2, -1) for _, e in gaps]
    marks.sort(key=lambda m: m[0])
    active, in_gap, prev = set(), False, 0.0
    inner, within = {}, {}
    for t, kind, k in marks:
        if in_gap and t > prev:
            around = [spans[j] for j in active]
            label = min(around, key=lambda sp: sp[2] - sp[1])[0] if around else "between jobs"
            inner[label] = inner.get(label, 0.0) + (t - prev)
            for name in {sp[0] for sp in around}:
                within[name] = within.get(name, 0.0) + (t - prev)
        prev = t
        if kind == 1:
            active.add(k)
        elif kind == -1:
            active.discard(k)
        else:
            in_gap = kind == 2
    return inner, within


def maps_hidden(window: harness.Window, program: list) -> dict:
    """The host maps against the march, job by job: the end of the job's
    last march kernel (the last to end of those that started inside its
    ``job:<i>`` span) and the ``rt.maps`` spans that started inside it.
    The part of each span before that end is hidden; a range is late when
    its maps end after it. The ranges are a job's ``rt.maps`` spans but the
    last (the passes over the whole map), each the maps of the ranges that
    landed together; a job with one span (the single-batch route) maps its
    one range in it."""
    march = sorted((s, e) for name, kind, s, e in window.events
                   if kind == "kernel" and is_march(name))
    all_maps = sorted((s, e) for name, _, s, e in program if name == "rt.maps")
    march_starts, maps_starts = [s for s, _ in march], [s for s, _ in all_maps]
    hidden, total, rows = 0.0, 0.0, {}
    for job, start, end in window.spans:
        if not job.startswith("job:"):
            continue
        # the march kernels and rt.maps spans that started in [start, end)
        ends = [e for _, e in march[bisect_left(march_starts, start):
                                    bisect_left(march_starts, end)]]
        maps = all_maps[bisect_left(maps_starts, start):bisect_left(maps_starts, end)]
        if not ends or not maps:
            continue
        last = max(ends)
        h = sum(max(0.0, min(e, last) - s) for s, e in maps)
        t = sum(e - s for s, e in maps)
        late = sum(e > last for s, e in (maps[:-1] if len(maps) > 1 else maps))
        hidden, total = hidden + h, total + t
        row = rows.setdefault(job, [0.0, 0.0, []])
        row[0], row[1] = row[0] + h, row[1] + t
        row[2].append(late)
    lates = [n for row in rows.values() for n in row[2]]
    return {
        "maps_hidden_share": hidden / total if total else None,
        "maps_hidden_by_row": {job: h / t for job, (h, t, _) in sorted(rows.items()) if t},
        "late_ranges_per_job": sum(lates) / len(lates) if lates else None,
        "late_ranges_by_row": {job: sorted(set(n)) for job, (_, _, n) in sorted(rows.items())},
    }


def kernel_share(window: harness.Window, program: list, layer: str, other: str) -> dict:
    """The calls of a layer by route: its ``rt.<layer>.kernel`` spans over
    those and its ``rt.<layer>.<other>`` spans, over the window
    (``<layer>_kernel_share``, None where it has none) and by the row of
    the ``job:<i>`` span each started in (``<layer>_kernel_by_row``)."""
    routes = (f"rt.{layer}.kernel", f"rt.{layer}.{other}")
    calls = [(name, s) for name, _, s, _ in program if name in routes]
    rows = {}
    for name, s in calls:
        job = next((j for j, js, je in window.spans if j.startswith("job:") and js <= s < je),
                   None)
        if job is not None:
            row = rows.setdefault(job, [0, 0])
            row[0] += name == routes[0]
            row[1] += 1
    kernel = sum(name == routes[0] for name, _ in calls)
    return {
        f"{layer}_kernel_share": kernel / len(calls) if calls else None,
        f"{layer}_kernel_by_row": {job: k / n for job, (k, n) in sorted(rows.items())},
    }


def bins_kernel(window: harness.Window, program: list) -> dict:
    """The bins' scatters by route: ``rt.bins.kernel`` against
    ``rt.bins.index_add``."""
    return kernel_share(window, program, "bins", "index_add")


def redshift_kernel(window: harness.Window, program: list) -> dict:
    """The emissivity's redshift chains by route: ``rt.redshift.kernel``
    against ``rt.redshift.torch``."""
    return kernel_share(window, program, "redshift", "torch")


def report(window: harness.Window, program: list, launches: list, uncounted: int) -> dict:
    """The numbers above, from a traced window, the program's spans on its
    clock as (name, parent, start s, end s) and the launches as (span
    index, lane iterations)."""
    jobs = [sp for sp in window.spans if sp[0].startswith("job:")]
    gaps = idle_gaps(window.events, window.window_s)
    idle = sum(e - s for s, e in gaps)
    labelled = list(window.spans) + [(name, s, e) for name, _, s, e in program]
    inner, within = idle_by_span(gaps, labelled)
    compute = any(name == "rt.compute" for name, *_ in program)
    compute_idle = within.get("rt.compute", 0.0)
    source = [e - s for name, _, s, e in program if name == "rt.source"]

    by_row = {}
    for index, iters in launches:
        t = program[index][2]
        job = next((sp for sp in jobs if sp[1] <= t < sp[2]), None)
        if job is not None:
            by_row.setdefault(job[0], {}).setdefault((job[1], job[2]), 0)
            by_row[job[0]][(job[1], job[2])] += iters
    iters_by_row = {row: sorted(set(per_job.values())) for row, per_job in sorted(by_row.items())}
    rows_mean = [sum(v) / len(v) for v in (list(p.values()) for p in by_row.values())]
    march_s = sum(e - s for name, kind, s, e in window.events
                  if kind == "kernel" and is_march(name))
    counted = sum(iters for _, iters in launches)

    n = max(window.jobs, 1)
    return {
        "jobs": window.jobs,
        "window_s": window.window_s,
        "idle_share": idle / window.window_s,
        "source_host_ms": 1e3 * sum(source) / n if source else None,
        "compute_idle_ms": 1e3 * compute_idle / n if compute else None,
        "compute_idle_share": compute_idle / idle if idle else None,
        "march_iters_per_job": sum(rows_mean) / len(rows_mean) if rows_mean else None,
        "iters_by_row": iters_by_row,
        "march_ns_per_iter": 1e9 * march_s / counted if counted else None,
        "launches_counted": len(launches),
        "launches_uncounted": uncounted,
        "idle_by_span": {k: 1e3 * v / n for k, v in sorted(inner.items(), key=lambda x: -x[1])},
        "breakdown": harness.breakdown(harness.Window(window.events, labelled, window.jobs,
                                                      window.window_s)),
        **maps_hidden(window, program),
        **bins_kernel(window, program),
        **redshift_kernel(window, program),
    }


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    os.environ.update(harness.run_environment())
    cell = harness.load_cell(harness.load_spec(), args.workload)
    import torch

    from raytrace_tpu_torch.utils import profiling

    if cell.config.get("host_threads"):
        torch.set_num_threads(int(cell.config["host_threads"]))
    if not torch.cuda.is_available():
        print("needs a CUDA device: no result", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize
    entry = harness.load_driver(cell.config["driver"])
    rows = harness.job_rows(cell.traffic)
    params = [harness.job_params(cell.config, r) for r in rows]
    rays = [entry.rays(q) for q in params]

    def run_job(i):
        return entry.run(params[i], device="cuda"), rays[i]

    entry.load("cuda")
    for i in {n: i for i, n in reversed(list(enumerate(rays)))}.values():
        run_job(i)
        sync()
    plain, _ = harness.run_window(run_job, rows, args.seed, args.seconds)
    spans = []
    profiling.start()  # its table is zeroed before the trace starts, read after it ends
    with harness.SourceSpans(entry.SOURCE, spans, sync):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_ref_ns, p_ref = time.time_ns(), time.perf_counter()
            jobs, errors = harness.run_window(run_job, rows, args.seed, args.seconds,
                                              spans=spans)
            sync()
            window_s = time.perf_counter() - p_ref
    rec = profiling.stop()
    spans = [(n, s - p_ref, e - p_ref) for n, s, e in spans]
    window = harness.Window(harness.device_events(prof, t_ref_ns), spans, len(jobs), window_s)
    program = [(n, parent, (s - t_ref_ns) * 1e-9, (e - t_ref_ns) * 1e-9)
               for n, parent, s, e in rec.spans]
    out = report(window, program, rec.launches, rec.uncounted)
    out.update(workload=args.workload, seed=args.seed, device=harness.smi_line(),
               failed=len(errors), launches_per_job=len(window.events) / max(len(jobs), 1),
               tracing_overhead=(harness.throughput(jobs)["rays_per_s"]
                                 / harness.throughput(plain)["rays_per_s"] - 1))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
