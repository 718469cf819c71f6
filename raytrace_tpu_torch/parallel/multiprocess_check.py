"""A real multi-process run of the sharded gradient and fitting steps.

Counterpart of ``raytrace_tpu/parallel/multiprocess_check.py``. The launcher
starts ``--procs`` processes joined over a TCP store on a free port of
127.0.0.1 (``torch.distributed``, no cluster needed), each one rank of a
``RayMesh``. Together they run the canonical sharded gradient step
(``sharded_emissivity_gradient`` on the dry-run lamppost grid: spin 0.998,
h 5, gamma 2, the 0.25 grid, 1024 iterations, r0 4, r_max 50) and the
line-profile fitting step (``sharded_line_profile_fit_step``), and the
launcher holds the result against one process running the same pipeline
alone. It writes a JSON record and exits non-zero when they disagree or a
rank fails.

    python -m raytrace_tpu_torch.parallel.multiprocess_check [out.json]
        [--device=cuda|cpu] [--procs=N] [--n_steps=N]

The card is the default: one process per visible card, over NCCL.
``--device=cpu`` runs gloo processes on the CPU (2 unless ``--procs``), one
thread each. ``--n_steps`` cuts both steps' iterations (default 1024 for
the gradient and 768 for the fit, as the JAX check).

``launch`` is the launcher itself: it runs any ``module:function`` over a
mesh of ranks and returns what each rank returned.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
GRAD_STEPS, FIT_STEPS = 1024, 768


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, nproc: int, *, device: str, backend: str | None = None,
           args: dict | None = None, timeout: float = 1800.0) -> list:
    """Run ``target`` ("module:function") in ``nproc`` processes, ranks 0 ..
    nproc-1 of one process group over a TCP store on a free local port:
    each calls ``function(mesh, **args)`` with its ``RayMesh`` on
    ``device`` ("cuda": card ``rank`` modulo the cards visible; "cpu", one
    thread a rank) and returns a dict of numbers or arrays. ``backend``
    defaults to NCCL on the card and gloo on the CPU. Returns the ranks'
    dicts in rank order; raises with the ranks' error output when one
    fails or the run outlasts ``timeout`` seconds. Every process started
    here has ended when it returns."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    port = _free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for rank in range(nproc):
            env = dict(os.environ)
            env.update(RT_MPC_RANK=str(rank), RT_MPC_NPROC=str(nproc),
                       RT_MPC_ADDR=f"tcp://127.0.0.1:{port}", RT_MPC_DEVICE=device,
                       RT_MPC_BACKEND=backend, RT_MPC_TARGET=target,
                       RT_MPC_ARGS=json.dumps(args or {}), RT_MPC_OUT=out,
                       LOCAL_RANK=str(rank),
                       PYTHONPATH=os.pathsep.join(filter(None, [str(_ROOT),
                                                                env.get("PYTHONPATH")])))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "raytrace_tpu_torch.parallel.multiprocess_check"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], False
        try:
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=timeout)[0])
                except subprocess.TimeoutExpired:
                    failed = True
                    logs.append("timed out")
                    break
                failed = failed or p.returncode != 0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            tail = "\n".join(f"--- rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
            raise RuntimeError(f"{target} failed on {nproc} {backend} rank(s):\n{tail}")
        results = []
        for rank in range(nproc):
            with np.load(os.path.join(out, f"rank{rank}.npz")) as data:
                results.append({k: data[k] for k in data.files})
        return results


def _worker() -> None:
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.parallel import make_ray_mesh

    rank, nproc = int(os.environ["RT_MPC_RANK"]), int(os.environ["RT_MPC_NPROC"])
    device = os.environ["RT_MPC_DEVICE"]
    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(os.environ["RT_MPC_BACKEND"], init_method=os.environ["RT_MPC_ADDR"],
                            world_size=nproc, rank=rank)
    try:
        mesh = make_ray_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        module, name = os.environ["RT_MPC_TARGET"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, **json.loads(os.environ["RT_MPC_ARGS"]))
        np.savez(os.path.join(os.environ["RT_MPC_OUT"], f"rank{rank}.npz"),
                 **{k: _host(v) for k, v in result.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _host(v):
    """A result value as a numpy array."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def check_case(mesh, grad_steps: int = GRAD_STEPS, fit_steps: int = FIT_STEPS) -> dict:
    """The checked pipeline on ``mesh``: the sharded gradient step on the
    dry-run grid and the line-profile fitting step (target at spin 0.9,
    incl 55; step at 0.85, 57; 9 x 9 camera at dist 100, r_disc 15)."""
    import torch

    from raytrace_tpu_torch.ops.diff import line_profile_from_xy
    from raytrace_tpu_torch.parallel import (sharded_emissivity_gradient,
                                             sharded_line_profile_fit_step)
    from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid

    grid = PointSourceGrid.from_steps(0.25, 0.25, -0.9, 0.9, -3.0, 3.0)
    value, grads = sharded_emissivity_gradient(0.998, 5.0, 2.0, grid, mesh, n_steps=grad_steps,
                                               r0=4.0, r_max=50.0)
    fit_grid = ImagePlaneGrid.from_steps(-10.5, 11.5, 2.75, -10.5, 11.5, 2.75)
    fx, fy = fit_grid.xy(device=mesh.device)
    energies = torch.linspace(0.3, 1.3, 48, dtype=torch.float64, device=mesh.device)
    with torch.no_grad():
        target = line_profile_from_xy(0.9, 55.0, fx, fy, dist=100.0, r_disc=15.0,
                                      n_steps=fit_steps, energies=energies)
    loss, fit_grads = sharded_line_profile_fit_step(0.85, 57.0, fit_grid, target, mesh,
                                                    dist=100.0, r_disc=15.0, n_steps=fit_steps)
    return {"value": float(value), "grads": [float(g) for g in grads], "fit_loss": float(loss),
            "fit_grads": [float(g) for g in fit_grads]}


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(multi: dict, single: dict) -> dict:
    """Relative gaps of a multi-process result from the single-process
    one: value, gradients (largest) and the fit's loss and gradients
    (largest)."""
    return {
        "value_rel_err": _rel(multi["value"], single["value"]),
        "grad_rel_err": max(_rel(a, b) for a, b in zip(multi["grads"], single["grads"])),
        "fit_rel_err": max([_rel(multi["fit_loss"], single["fit_loss"])]
                           + [_rel(a, b) for a, b in zip(multi["fit_grads"], single["fit_grads"])]),
    }


# the gates: the ranks march the same rays as the single process, bit for
# bit, so only the sums over rays reassociate
RTOL = 1e-10


def _launch(argv) -> int:
    import argparse

    import torch

    from raytrace_tpu_torch.parallel import make_ray_mesh

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.parallel.multiprocess_check")
    ap.add_argument("out", nargs="?", default="MULTIPROC.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--procs", type=int, default=None)
    ap.add_argument("--n_steps", type=int, default=None)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device=cpu for gloo on the CPU")
    nproc = a.procs or (torch.cuda.device_count() if a.device == "cuda" else 2)
    steps = dict(grad_steps=a.n_steps or GRAD_STEPS, fit_steps=a.n_steps or FIT_STEPS)
    backend = "nccl" if a.device == "cuda" else "gloo"
    ranks = launch("raytrace_tpu_torch.parallel.multiprocess_check:check_case", nproc,
                   device=a.device, backend=backend, args=steps)
    multi = {k: v.tolist() for k, v in ranks[0].items()}
    same = all(np.array_equal(r[k], ranks[0][k]) for r in ranks for k in multi)
    single = check_case(make_ray_mesh(device=a.device), **steps)
    gaps = compare(multi, single)
    finite = all(math.isfinite(x) for x in [multi["value"], multi["fit_loss"]]
                 + multi["grads"] + multi["fit_grads"])
    record = {"ok": bool(same and finite and max(gaps.values()) < RTOL),
              "n_processes": nproc, "device": a.device, "backend": backend, **steps,
              "ranks_agree": same, "multi_process": multi, "single_process": single,
              **gaps, "rtol": RTOL}
    print(json.dumps(record))
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0 if record["ok"] else 1


def main(argv=None) -> int:
    if "RT_MPC_RANK" in os.environ:
        _worker()
        return 0
    return _launch(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
