"""The port's line-profile app (apps/line_profile.py) against the JAX
package's ``rt-line-profile``, in both modes, with ``--device=cpu``.

The trace mode runs the spec of tests/test_cli_sweep.py (dist 500, incl 60,
spin 0.9, r_disc 15, 24 rays a side, 30 bins, RK45 at steplim 20000): the
port's disc image marches in float64 on the CPU. The image mode folds a
disc-image FITS file that the JAX CLI wrote (tests/test_cli_sweep.py:646).

The JAX package is imported inside the tests that use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import line_profile as port_app  # noqa: E402
from raytrace_tpu_torch.io import read_fits  # noqa: E402

LINE = ["--dist=500", "--incl=60", "--spin=0.9", "--r_disc=15", "--Nx=24", "--Nen=30",
        "--steplim=20000"]


def _both(tmp_path, argv):
    from raytrace_tpu.apps.line_profile import main as jax_main

    j, p = tmp_path / "jax.dat", tmp_path / "port.dat"
    assert jax_main([f"--outfile={j}"] + argv) == 0
    assert port_app.main([f"--outfile={p}", "--device=cpu"] + argv) == 0
    return np.atleast_2d(np.loadtxt(j)), np.atleast_2d(np.loadtxt(p))


def test_trace_mode_matches_jax(tmp_path):
    """The profile's 30 bins: centres equal as written, each bin to 1e-5 of
    the largest (measured 3.3e-7: the bins sum the float64 disc image, whose
    marches agree to rounding)."""
    a, b = _both(tmp_path, LINE)
    assert b.shape == a.shape == (30, 2) and b[:, 1].sum() > 0
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=1e-5, atol=1e-5 * a[:, 1].max())


def test_image_mode_matches_jax(tmp_path):
    """--image= mode on a disc-image FITS file written by the JAX CLI (the
    spec of tests/test_cli_sweep.py:646-660): the port's profile equals
    JAX's post-processing of the same file as written."""
    from raytrace_tpu.apps.imageplane_disc_image import main as jax_image

    img = tmp_path / "img.fits"
    assert jax_image([f"--outfile={img}", "--dist=500", "--incl=60", "--spin=0.9",
                      "--r_disc=15", "--Nx=24", "--img_Nx=24", "--steplim=20000"]) == 0
    a, b = _both(tmp_path, [f"--image={img}", "--line_en=6.4", "--Nen=40"])
    assert b.shape == a.shape == (40, 2) and b[:, 1].sum() > 0
    np.testing.assert_array_equal(b, a)

    maps = read_fits(str(img))
    centres, prof = port_app.line_profile_from_maps(np.nan_to_num(maps["FLUX"].astype(float)),
                                           np.nan_to_num(maps["ENSHIFT"].astype(float)),
                                           maps["NRAYS"].astype(float), 6.4, 40)
    np.testing.assert_allclose(b[:, 0], centres, rtol=1e-5)
    np.testing.assert_allclose(b[:, 1], prof, rtol=1e-5, atol=1e-5 * prof.max())
