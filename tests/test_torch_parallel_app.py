"""An app's ``main`` under a torchrun-style launch on the CPU: the
emissivity CLI with tests/test_cli_sweep.py's argv for rt-emissivity (the
lamppost on the 0.1 x 0.2 grid, RK45, steplim 4000), started as two gloo
ranks the way ``torchrun --nproc-per-node=2`` starts it (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment, no process group yet), beside one process started without
them. ``parallel.auto_mesh`` joins the group itself, so the ranks split the
rays, and only rank 0 writes the file.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from test_cli_sweep import spec_emissivity  # noqa: E402

from raytrace_tpu_torch.parallel.multiprocess_check import _free_port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _start(argv, **env):
    """``python -m raytrace_tpu_torch.apps.emissivity argv`` on one thread,
    with ``env`` added to a copy of this process's environment."""
    full = dict(os.environ, OMP_NUM_THREADS="1", **env)
    full["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), full.get("PYTHONPATH")]))
    for key in ("RT_PROGRESS", "RT_PROFILE", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        if key not in env:
            full.pop(key, None)
    return subprocess.Popen([sys.executable, "-m", "raytrace_tpu_torch.apps.emissivity",
                             *argv, "--device=cpu"], env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_emissivity_main_over_two_torchrun_ranks(tmp_path):
    """Two ranks and one lone process, all started together. Rank 0 prints
    the sharding line and writes its file; rank 1 marches its half and
    writes nothing (its own ``--outfile`` stays absent). The file equals
    the lone process's: radii, areas and ray counts exactly, the four sums
    to rtol 1e-12 (the ranks' bins are summed by one all_reduce, which
    reassociates them)."""
    argv, _ = spec_emissivity(tmp_path)
    outs = [tmp_path / f"rank{r}.dat" for r in range(2)]
    alone = tmp_path / "alone.dat"
    port = str(_free_port())
    procs = [_start(argv + [f"--outfile={outs[r]}"], WORLD_SIZE="2", RANK=str(r),
                    LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
             for r in range(2)]
    procs.append(_start(argv + [f"--outfile={alone}"]))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    n_rays = 640  # the 0.1 x 0.2 grid
    assert f"sharding {n_rays} rays over 2 devices" in logs[0]
    assert f"wrote {outs[0]}" in logs[0] and "wrote" not in logs[1] and "sharding" not in logs[2]
    assert outs[0].exists() and not outs[1].exists()

    got, ref = np.loadtxt(outs[0]), np.loadtxt(alone)
    assert got.shape == ref.shape == (15, 7) and ref[:, 2].sum() > 0
    np.testing.assert_array_equal(got[:, :3], ref[:, :3])
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=1e-12)
