"""The port's caustic maps against the reference binary's goldens.

tests/test_caustics.py:97-219 on the port, with its gates: the discplane
(dist 500, incl 60, r_disc 20, 81 x 81 bundles, RK45, steplim 60000) and
sourceplane (dist 500, incl 30, r_lim 1000, 82 x 82, RK45, steplim 1e5)
goldens on the CPU (plain march, f64; about 15 s and 8 s on one thread).
The plane golden (dist 500, incl 30, z_s 500, 81 x 81 bundles) takes about
4 minutes of plain march on the CPU, so it runs on the card only (f64
kernel):

    python -m pytest --noconftest -m cuda tests/test_torch_caustics_golden.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps.caustics import SENTINEL, compute  # noqa: E402
from raytrace_tpu_torch.sources import ImagePlaneGrid  # noqa: E402

SPIN = 0.998
GOLDEN = "tests/golden/caustic_{}_a0.998_i{}_rk45.bin"
NAMES = {
    "discplane": ["det_j", "sign_j", "order", "hit", "radius", "phi", "x_disc", "y_disc",
                  "redshift"],
    "plane": ["det_j", "sign_j", "order", "hit", "x_s", "y_s", "rdot_flips", "equat_cross"],
    "sourceplane": ["det_j", "sign_j", "order", "escaped", "theta_s", "phi_s", "rdot_flips",
                    "equat_cross"],
}


def _golden(app, incl, n):
    raw = np.fromfile(GOLDEN.format(app, incl), "<f8")
    return {nm: raw[i * n * n:(i + 1) * n * n].reshape(n, n) for i, nm in enumerate(NAMES[app])}


def _jacobian_gates(maps, ref, both, min_pixels, median, p90, sign):
    """det J where both hit, the orders agree and neither is SENTINEL."""
    om = maps["order"]
    assert (om[both] == ref["order"][both]).mean() > 0.999
    dm, dr = maps["det_j"], ref["det_j"]
    ok = (both & np.isfinite(dm) & np.isfinite(dr) & (dm != SENTINEL)
          & (np.abs(dr) < 1e29) & (om == ref["order"]))
    assert ok.sum() > min_pixels
    rel = np.abs(dm[ok] / dr[ok] - 1)
    assert np.median(rel) < median, f"det_j median {np.median(rel)}"
    assert np.percentile(rel, 90) < p90
    assert (np.sign(dm[ok]) == np.sign(dr[ok])).mean() > sign


def check_discplane(device):
    """tests/test_caustics.py::test_caustic_matches_reference_binary."""
    ref = _golden("discplane", 60, 81)
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, 0.3, -12.0, 12.0, 0.3)
    maps = compute(SPIN, 500.0, 60.0, grid, target="disc", r_disc=20.0, method="rk45",
                   steplim=60000, bundle_eps_frac=0.01, device=device)
    hit_m, hit_r = maps["hit"].astype(bool), ref["hit"] > 0.5
    assert (hit_m == hit_r).mean() > 0.985
    both = hit_m & hit_r
    for f in ("radius", "redshift"):
        rel = np.abs(maps[f][both] / ref[f][both] - 1)
        assert np.median(rel) < 1e-5, f"{f} median {np.median(rel)}"
    _jacobian_gates(maps, ref, both, 3000, 0.02, 0.10, 0.99)


def check_sourceplane(device):
    """tests/test_caustics.py::test_caustic_sourceplane_matches_reference_binary."""
    ref = _golden("sourceplane", 30, 82)
    dx = 24.0 / 81
    grid = ImagePlaneGrid.from_steps(-12.0, 12.0, dx, -12.0, 12.0, dx)
    maps = compute(SPIN, 500.0, 30.0, grid, target="sphere", r_lim=1000.0, method="rk45",
                   steplim=100000, device=device)
    em, er = maps["escaped"].astype(bool), ref["escaped"] > 0.5
    assert (em == er).mean() > 0.999
    both = em & er
    assert np.median(np.abs(maps["theta_s"][both] - ref["theta_s"][both])) < 1e-7
    d = np.abs(maps["phi_s"][both] - ref["phi_s"][both])
    assert np.median(np.minimum(d, 2 * np.pi - d)) < 1e-7
    _jacobian_gates(maps, ref, both, 4000, 1e-4, 1e-3, 0.999)


def check_plane(device):
    """tests/test_caustics.py::test_caustic_plane_matches_reference_binary."""
    ref = _golden("plane", 30, 81)
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 0.25, -10.0, 10.0, 0.25)
    maps = compute(SPIN, 500.0, 30.0, grid, target="plane", z_s=500.0, method="rk45",
                   steplim=100000, bundle_eps_frac=0.01, device=device)
    hm, hr = maps["hit"].astype(bool), ref["hit"] > 0.5
    assert (hm == hr).mean() > 0.985
    both = hm & hr
    for f in ("x_s", "y_s"):
        d = np.abs(maps[f][both] - ref[f][both])
        assert np.median(d) < 1e-4, f"{f} median {np.median(d)}"
    _jacobian_gates(maps, ref, both, 2000, 0.01, 0.05, 0.99)


def test_discplane_matches_reference_binary():
    check_discplane("cpu")


def test_sourceplane_matches_reference_binary():
    check_sourceplane("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["discplane", "plane", "sourceplane"])
def test_goldens_on_cuda(app):
    """The three goldens through the f64 march kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plane golden's plain march takes minutes")
    {"discplane": check_discplane, "plane": check_plane, "sourceplane": check_sourceplane}[app](
        "cuda")
