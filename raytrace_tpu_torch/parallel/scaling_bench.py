"""Weak-scaling benchmark of the sharded emissivity step.

Counterpart of ``raytrace_tpu/parallel/scaling_bench.py``: rays/s of the
canonical lamppost workload (spin 0.998, source at h 5, RK4, steplim 4000,
100 log bins out to r 500) at world sizes 1, 2, 4, ... up to the cards
visible, 16,384 rays a rank (weak scaling), and each world's
efficiency against world 1 (rays/s a rank over world 1's rays/s). Each
world size is one ``multiprocess_check.launch`` of that many ranks (NCCL,
one a card); a rank builds the whole batch, marches and bins its shard
through ``sharded_emissivity_bins`` once to warm up and once timed
(synchronised, between two barriers), and rank 0's wall is the world's.

    python -m raytrace_tpu_torch.parallel.scaling_bench [--device=cuda|cpu] [--max_world=N]

On one card it measures world 1 alone, and says so. Every time printed
stands beside the card's ``nvidia-smi --query-gpu=name,power.limit`` line.
``--device=cpu`` runs gloo ranks on the CPU: that checks the mechanics
only, the ranks sharing the host's cores.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

SPIN = 0.998


def _smi() -> str:
    """The card's name and power limit, or why they are not known."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi: failed"


def measure(mesh, rays_per_shard: int, steplim: int) -> dict:
    """One world's timed run on ``mesh`` (a ``multiprocess_check.launch``
    target): the weak-scaling batch of ``rays_per_shard`` x ranks rays,
    marched and binned once to warm up and once timed."""
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.ops.reductions import bin_edges
    from raytrace_tpu_torch.parallel import pad_rays, shard_rays, sharded_emissivity_bins
    from raytrace_tpu_torch.sources import PointSourceGrid, point_source

    total = rays_per_shard * mesh.size
    d = math.sqrt(2.0 * 2 * math.pi / total)
    grid = PointSourceGrid.from_steps(d, d, -0.995, 0.995, -math.pi, math.pi)
    rays = point_source((0.0, 5.0, 1e-3, 0.0), 0.0, SPIN, grid, device=mesh.device)
    shard = shard_rays(pad_rays(rays, mesh.size), mesh)
    r_min = 1.3
    _, _, dr = bin_edges(r_min, 500.0, 100, True, device="cpu")
    kw = dict(r_min=r_min, dr=float(dr), n_r=100, n_primary=float(grid.n_rays), method="rk4",
              r_max=1000.0, steplim=steplim)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)

    counts, _ = sharded_emissivity_bins(shard, SPIN, mesh, **kw)
    sync()
    t0 = time.perf_counter()
    counts, _ = sharded_emissivity_bins(shard, SPIN, mesh, **kw)
    sync()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "rays": rays.n_rays, "binned": float(counts.sum())}


def run(device: str = "cuda", max_world: int | None = None, rays_per_shard: int = 16384,
        steplim: int = 4000) -> list:
    """Measure each world size; returns one record a world, printed as a
    JSON line each with the card's line beside it."""
    import torch

    from raytrace_tpu_torch.parallel.multiprocess_check import launch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device=cpu for gloo on the CPU")
    visible = torch.cuda.device_count() if device == "cuda" else 1
    limit = max_world or visible
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= limit]
    card = _smi() if device == "cuda" else "cpu (gloo ranks sharing the host)"
    results = []
    for n in sizes:
        rank0 = launch("raytrace_tpu_torch.parallel.scaling_bench:measure", n, device=device,
                       args=dict(rays_per_shard=rays_per_shard, steplim=steplim))[0]
        rec = {"world": n, "rays": int(rank0["rays"]), "wall_s": float(rank0["wall_s"]),
               "rays_per_s": float(rank0["rays"]) / float(rank0["wall_s"]),
               "binned": float(rank0["binned"]), "card": card}
        if results:
            rec["weak_scaling_efficiency"] = rec["rays_per_s"] / n / results[0]["rays_per_s"]
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if len(sizes) == 1:
        print(f"scaling_bench: {visible} {device} device(s) visible: measured world 1 alone, "
              "no scaling figure", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.parallel.scaling_bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max_world", type=int, default=None)
    a = ap.parse_args(argv)
    run(a.device, a.max_world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
