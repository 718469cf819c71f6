"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

Everything here is general. What belongs to one configuration, traffic mix
or per-layer metric lives in a file of its own, found by name:

- ``configs/<config>.json``: the job parameters as the par file gives them
  (``par``), the stated precision, the driver's name, the comparison's
  limits (``limits``) and its sample (``check``), and torch's host threads
  where the deployment sets them (``host_threads``);
- ``drivers/<driver>.py``: the port's entry imported and its kernels loaded
  (``load``), one job's parameters into one call of that entry (``run``),
  the rays a job traces (``rays``), the source-layer entry
  a traced run times (``SOURCE``), and the plain reference's answer with
  the numbers that compare the two (``reference``, ``compare``);
- ``traffic/<traffic>.json``: the job table (a ``grid`` whose product gives
  the rows; a key with one value is fixed) and how many of the window's
  jobs the reference checks (``check_jobs``);
- ``metrics/<metric>.py``: ``read(window)``, one per-layer number from a
  traced window (``Window``), or None where it finds nothing to read.

The loop is closed, with one caller: each job is one call of the port's
entry, which returns host arrays, so the call ends synchronised with the
card. Jobs visit the table's rows in cycles, each cycle in an order drawn
from ``--seed``; they start until ``--seconds`` have passed, and the job in
flight then finishes and counts.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import itertools
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules whose top-level name may never be loaded in a run, compared whole:
# the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")


def run_environment(root: Path = ROOT) -> dict:
    """The environment a run sets before torch loads: the fixed directories
    inside the checkout where Triton and torch's extension builds keep their
    caches (the march library builds into the port's own ``_build/`` beside
    its package), and ``USE_FLAX=0``. Torch's host threads are set by
    ``main`` from the configuration."""
    cache = root / "portbench" / ".cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"), "USE_FLAX": "0"}


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock, from /proc."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / ticks


# ---- what BENCHMARK.json and the files it names hold ----

def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the spec with everything its name leads to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the spec has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)], root=root)


def _load(kind: str, name: str, root: Path):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded from its file."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_portbench_{kind}_{name}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind[:-1]} {name!r}: {path} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quantity(metric: str) -> str:
    """What a metric measures: its name before any ".<group>" suffix. A
    quantity is split into groups where cells need bounds of their own, or
    report different end-to-end metrics (``rays_per_s.image``)."""
    return metric.split(".", 1)[0]


def load_driver(name: str, root: Path = ROOT):
    return _load("drivers", name, root)


def load_metric(name: str, root: Path = ROOT):
    return _load("metrics", name, root)


def job_rows(traffic: dict) -> list:
    """The traffic's job table: the product of its ``grid``'s value lists."""
    keys = list(traffic["grid"])
    return [dict(zip(keys, vals)) for vals in itertools.product(*traffic["grid"].values())]


def job_params(config: dict, row: dict) -> dict:
    """A job's parameters: the configuration's par values with the row over them."""
    return dict(config["par"], **row)


def row_label(row: dict, traffic: dict) -> str:
    keys = [k for k, v in traffic["grid"].items() if len(v) > 1] or list(row)
    return ",".join(f"{k}={row[k]}" for k in keys)


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator drawn from the run's seed (any whole number) and a stream."""
    return np.random.default_rng([seed % 2**64, *stream])


def cycle_order(n_rows: int, seed: int, cycle: int) -> list:
    """The rows' order in one cycle of the window: a permutation from the seed."""
    return [int(i) for i in seed_rng(seed, 1, cycle).permutation(n_rows)]


class Reservoir:
    """A uniform sample of ``k`` of the window's jobs, drawn from the seed
    as they complete (the sampled jobs' outputs are kept, no others)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, seed_rng(seed, 2), 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = item


# ---- the window ----

@dataclasses.dataclass
class Job:
    row: int
    start: float
    end: float
    rays: int


@dataclasses.dataclass
class Window:
    """What a traced window left for the per-layer readers: the device's
    operations as (name, kind, start s, end s), kind "kernel", "memcpy" or
    "memset"; the harness's spans as (name, start s, end s); both from the
    window's start; the jobs completed and the window's length in s."""

    events: list
    spans: list
    jobs: int
    window_s: float


def run_window(run_job, rows, seed, seconds, spans=None, keep=None):
    """Closed-loop jobs, one caller: ``run_job(row)`` over the rows in seeded
    cycles until ``seconds`` have passed. Returns the jobs and the errors;
    ``keep.offer`` sees each completed job's (row, output)."""
    jobs, errors = [], []
    t0 = time.perf_counter()
    for cycle in itertools.count():
        for i in cycle_order(len(rows), seed, cycle):
            if time.perf_counter() - t0 >= seconds:
                return jobs, errors
            start = time.perf_counter()
            try:
                out, rays = run_job(i)
            except Exception as e:  # a job that fails is counted, the loop goes on
                errors.append(f"{type(e).__name__}: {e}")
                continue
            end = time.perf_counter()
            jobs.append(Job(i, start, end, rays))
            if spans is not None:
                spans.append((f"job:{i}", start, end))
            if keep is not None:
                keep.offer((i, out))
    raise AssertionError("unreachable")


def throughput(jobs) -> dict:
    rays = sum(j.rays for j in jobs)
    span = jobs[-1].end - jobs[0].start
    walls = [1e3 * (j.end - j.start) for j in jobs]
    return {"rays_per_s": rays / span, "job_p95_ms": float(np.percentile(walls, 95))}


# ---- the trace ----

def device_events(prof, t_ref_ns: int) -> list:
    """The card's operations in a torch.profiler run as (name, kind, start
    s, end s) from ``t_ref_ns`` (the ``time.time_ns`` clock, which kineto's
    timestamps share); the kind from the name: "memcpy", "memset" or
    "kernel"."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name = e.name()
        low = name.lower()
        kind = "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") \
            else "kernel"
        start = (e.start_ns() - t_ref_ns) * 1e-9
        out.append((name, kind, start, start + e.duration_ns() * 1e-9))
    out.sort(key=lambda x: x[2])
    return out


def busy_intervals(events) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    merged = []
    for _, _, s, e in sorted(events, key=lambda x: x[2]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_seconds(events, window_s: float) -> float:
    return sum(min(e, window_s) - max(s, 0.0) for s, e in busy_intervals(events)
               if e > 0 and s < window_s)


def breakdown(window: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    labelled by the innermost harness span around each (or "between jobs")."""
    by_name = {}
    for name, _, s, e in window.events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    edges = [0.0] + [x for iv in busy_intervals(window.events) for x in iv] + [window.window_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def label(mid):
        around = [sp for sp in window.spans if sp[1] <= mid < sp[2]]
        return min(around, key=lambda sp: sp[2] - sp[1])[0] if around else "between jobs"

    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[label((s + e) / 2), e - s] for s, e in gaps]}


class SourceSpans:
    """Wraps the source layer's entry (a module attribute the driver names)
    so each call records a span, the card synchronised at both ends."""

    def __init__(self, target, spans, sync):
        self.module = importlib.import_module(target[0])
        self.attr, self.spans, self.sync = target[1], spans, sync
        self.original = getattr(self.module, self.attr)

    def __enter__(self):
        original, spans, sync = self.original, self.spans, self.sync

        def timed(*args, **kwargs):
            sync()
            start = time.perf_counter()
            out = original(*args, **kwargs)
            sync()
            spans.append(("source", start, time.perf_counter()))
            return out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.original)


# ---- device, correctness, result ----

def smi_line(fields: str = "name,power.limit") -> str:
    """The card's ``fields`` (by default its name and power limit), as
    nvidia-smi reads them."""
    import subprocess

    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_jobs(driver, config, rows, kept, seed, device) -> dict:
    """The plain reference over the sampled jobs: for each number the
    driver compares, the worst over the jobs."""
    worst = {}
    for n, (i, out) in enumerate(kept):
        par = job_params(config, rows[i])
        sample = driver.sample(par, config, seed_rng(seed, 3, n))
        ref = driver.reference(par, sample, config, device=device)
        for k, v in driver.compare(out, ref, sample).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit, in the limits' order;
    a number that is missing or not finite fails, and is written as a string."""
    values = {k: float(numbers.get(k, math.inf)) for k in limits}
    ok = all(v <= limits[k] for k, v in values.items())
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
              for k, v in values.items()}
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float | None = None, log=print) -> dict:
    """One run of ``cell`` on ``device``: set-up and warm-up, the window
    (traced with ``trace``), the reference's check. Returns the result's
    fields (the caller adds ``device``)."""
    import torch

    t_process = time.time() if t_process is None else t_process
    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    driver = load_driver(cell.config["driver"], cell.root)
    rows = job_rows(cell.traffic)
    params = [job_params(cell.config, r) for r in rows]
    rays = [driver.rays(p) for p in params]

    def run_job(i):
        return driver.run(params[i], device=device), rays[i]

    marks = [("before the port loaded", time.time())]
    if driver.load(device):
        marks.append(("the port loaded, its kernels built", time.time()))
    else:
        marks.append(("the port loaded", time.time()))
    # warm-up: one job of each shape (rays a job) the table holds; the rows
    # of one shape launch the same kernels on the same sizes
    shapes = {}
    for i, n in enumerate(rays):
        shapes.setdefault(n, i)
    for i in shapes.values():
        run_job(i)
        sync()
    marks.append((f"{len(shapes)} warm-up job(s)", time.time()))
    setup_s = time.time() - t_process
    log("set-up: " + ", ".join(f"{what} at {t - t_process:.3f} s" for what, t in marks))
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    keep = Reservoir(int(cell.traffic.get("check_jobs", 1)), seed)
    metrics, extra = {}, {}
    if not trace:
        jobs, errors = run_window(run_job, rows, seed, seconds, keep=keep)
        if jobs:
            values = dict(throughput(jobs), setup_s=setup_s)
            metrics = {m["name"]: {"value": values[quantity(m["name"])], "unit": m["unit"]}
                       for m in cell.end_to_end}
    else:
        plain, _ = run_window(run_job, rows, seed, seconds)
        spans = []
        kind = "CUDA" if on_card else "CPU"
        activities = [getattr(torch.profiler.ProfilerActivity, kind)]
        with SourceSpans(driver.SOURCE, spans, sync):
            with torch.profiler.profile(activities=activities) as prof:
                t_ref_ns, p_ref = time.time_ns(), time.perf_counter()
                jobs, errors = run_window(run_job, rows, seed, seconds, spans=spans, keep=keep)
                sync()
                window_s = time.perf_counter() - p_ref
        spans = [(n, s - p_ref, e - p_ref) for n, s, e in spans]
        window = Window(device_events(prof, t_ref_ns), spans, len(jobs), window_s)
        kinds = {k: sum(1 for e in window.events if e[1] == k)
                 for k in ("kernel", "memcpy", "memset")}
        log(f"trace: {len(window.events)} device operations {kinds} in {window_s:.3f} s, the "
            f"first at {window.events[0][2] if window.events else None!r} s, the last ending at "
            f"{window.events[-1][3] if window.events else None!r} s")
        for m in cell.per_layer:
            value = load_metric(quantity(m["name"]), cell.root).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": busy_seconds(window.events, window_s), "window_s": window_s,
                 "breakdown": breakdown(window)}
        if plain and jobs:
            untraced, traced = throughput(plain)["rays_per_s"], throughput(jobs)["rays_per_s"]
            log(f"tracing overhead: rays_per_s traced {traced!r} untraced {untraced!r} "
                f"({traced / untraced - 1:+.4f})")
    sync()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:  # the reference runs on what the port's jobs leave free
        torch.cuda.empty_cache()
        log(f"card at the window's close (SM clock, max, power, temperature): "
            f"{smi_line('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")

    log(f"window: {len(jobs)} jobs, {sum(j.rays for j in jobs)} rays, {len(errors)} failed"
        + (f" (first: {errors[0]})" if errors else ""))
    for i, row in enumerate(rows):
        walls = [1e3 * (j.end - j.start) for j in jobs if j.row == i]
        if walls:
            log(f"row {row_label(row, cell.traffic)}: {len(walls)} jobs, median "
                f"{statistics.median(walls)!r} ms, {rays[i]} rays")
    t_check = time.perf_counter()
    numbers = check_jobs(driver, cell.config, rows, keep.kept, seed, device)
    log(f"reference: {len(keep.kept)} job(s) of rows "
        f"{[row_label(rows[i], cell.traffic) for i, _ in keep.kept]} checked in "
        f"{time.perf_counter() - t_check:.1f} s")
    ok, checks = verdict(numbers, cell.config["limits"])
    correct = ok and not errors and bool(jobs)
    return dict(correct=correct, attempted=len(jobs) + len(errors), failed=len(errors),
                metrics=metrics, memory_peak_bytes=memory_peak, extra=extra, checks=checks)


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_process: float) -> int:
    args = parse_args(argv)
    cell = load_cell(load_spec(), args.workload)
    import torch

    t_torch = time.time()
    if cell.config.get("host_threads"):  # else torch's default, one a core
        torch.set_num_threads(int(cell.config["host_threads"]))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), {n} visible: no result", file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.empty(1, device="cuda")
    print(f"set-up: torch imported at {t_torch - t_process:.3f} s, CUDA context at "
          f"{time.time() - t_process:.3f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {smi_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.get_num_threads()} host thread(s)")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}: no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if args.trace:
        device.update(busy_s=res["extra"]["busy_s"], window_s=res["extra"]["window_s"])
        line["breakdown"] = res["extra"]["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
