"""Where the image-plane camera is seeded: on the batch's own device.

``image_plane`` and ``image_plane_bundles`` compute every float64 field on
the device they are given; the scalars (distance, inclination, phi0) stay
0-d float64 CPU tensors. On the CPU the construction is held bitwise to the
host construction (plane points and ``_plane_ray`` on the CPU, one rounding
a field), so the two keep one order of operations. On the meta device it is
held to doing no work on a CPU tensor of more than one element: no per-ray
host arithmetic and no copy of a batch to the device. On the card it is
held to the host camera at the disc_image_isco benchmark's full grid: plane
points and r bitwise, the other float64 fields within a few ulp, and the
march's float32 starts counted. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_imageplane_device.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from raytrace_tpu_torch.sources import (  # noqa: E402
    ImagePlaneGrid,
    image_plane,
    image_plane_bundles,
)
from raytrace_tpu_torch.sources.imageplane import _plane_ray  # noqa: E402

SPIN = 0.998
F64 = torch.float64
# the camera's own fields: the rest of the batch is blank_batch's
PLANE_FIELDS = ("t", "r", "theta", "phi", "pt", "pr", "ptheta", "pphi", "k", "h", "Q",
                "rdot_sign", "thetadot_sign", "alpha", "beta")
# (dist, half-width, spacing): the golden geometry and the par_example's
# far field; both grids hold the knife-edge row y = 0
GRIDS = {"d500": (500.0, 20.0, 0.5), "d1e4": (1e4, 30.0, 0.6)}


def _host_batch(x, y, dist, incl, phi0, *, dtype, work_dtype):
    """The host construction: ``_plane_ray`` on CPU float64 plane points,
    the scalars as 0-d float64 CPU tensors, each field rounded once to
    ``dtype``."""
    parts = _plane_ray(x, y, torch.tensor(dist, dtype=F64),
                       torch.tensor(incl, dtype=F64) * torch.pi / 180.0,
                       torch.tensor(phi0, dtype=F64), -SPIN, torch.finfo(work_dtype).eps)
    t, r, theta, phi, mom, consts, rdot_sign, thetadot_sign = parts
    fields = (t, r, theta, phi, *mom, *consts, rdot_sign, thetadot_sign, x, y)
    return {f: v.to(dtype) for f, v in zip(PLANE_FIELDS, fields)}


def _assert_batch_equal(rays, ref, n):
    for f in rays.__dataclass_fields__:
        got = getattr(rays, f)
        assert got.shape == (n,), f
        if f in ref:
            assert got.dtype == ref[f].dtype, f
            np.testing.assert_array_equal(got.numpy(), ref[f].numpy(), err_msg=f)
        elif f == "steps":
            assert (got == 0).all()


@pytest.mark.parametrize("work", ["float32", "float64"])
@pytest.mark.parametrize("incl", [30.0, 60.0, 80.0])
@pytest.mark.parametrize("geom", list(GRIDS))
def test_device_camera_on_the_cpu_is_the_host_camera(geom, incl, work):
    """``image_plane(device="cpu")`` is bitwise the host construction, every
    field, for a float32 and a float64 march."""
    dist, w, d = GRIDS[geom]
    grid = ImagePlaneGrid.from_steps(-w, w, d, -w, w, d)
    work_dtype = getattr(torch, work)
    rays = image_plane(dist, incl, grid, SPIN, 0.3, device="cpu", work_dtype=work_dtype)
    x, y = grid.xy()
    assert 0.0 in y
    ref = _host_batch(x, y, dist, incl, 0.3, dtype=F64, work_dtype=work_dtype)
    _assert_batch_equal(rays, ref, grid.n_rays)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_bundles_on_the_cpu_are_the_host_bundles(dtype):
    """``image_plane_bundles(device="cpu")``: the five offset grids' host
    construction, bitwise, with the march dtype the batch dtype."""
    dt = getattr(torch, dtype)
    grid = ImagePlaneGrid.from_steps(-6.0, 6.0, 1.5, -6.0, 6.0, 1.5)
    rays, eps = image_plane_bundles(1e4, 45.0, grid, SPIN, -0.7, device="cpu", dtype=dt)
    xc, yc = grid.xy()
    offsets = [(0.0, 0.0), (eps, 0.0), (-eps, 0.0), (0.0, eps), (0.0, -eps)]
    x = torch.cat([xc + ox for ox, _ in offsets])
    y = torch.cat([yc + oy for _, oy in offsets])
    ref = _host_batch(x, y, 1e4, 45.0, -0.7, dtype=dt, work_dtype=dt)
    _assert_batch_equal(rays, ref, 5 * grid.n_rays)


class _HostWork(TorchDispatchMode):
    """Records each operation that reads or makes a CPU tensor of more than
    one element: per-ray host arithmetic, or a batch on its way to a device."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.numel() > 1
               for t in tree_leaves((args, kwargs, out))):
            self.ops.append(str(func))
        return out


def _seed_on(device, bundles):
    grid = ImagePlaneGrid.from_steps(-30.0, 30.0, 0.6, -30.0, 30.0, 0.6)
    with _HostWork() as seen:
        if bundles:
            rays, _ = image_plane_bundles(1e4, 60.0, grid, SPIN, device=device)
        else:
            rays = image_plane(1e4, 60.0, grid, SPIN, device=device, work_dtype=torch.float32)
    return rays, seen.ops


@pytest.mark.parametrize("bundles", [False, True], ids=["image_plane", "bundles"])
def test_device_camera_does_no_per_ray_host_work(bundles):
    """Seeded on a device that is not the CPU (meta here, as the card), no
    operation touches a CPU tensor of more than one element, and every
    field is on that device; on the CPU the same check sees the work."""
    rays, ops = _seed_on("meta", bundles)
    assert ops == []
    for f in PLANE_FIELDS:
        assert getattr(rays, f).device.type == "meta", f
    _, host_ops = _seed_on("cpu", bundles)
    assert len(host_ops) > 50


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card camera runs CUDA's libdevice")
    return torch.device("cuda")


# the disc_image_isco benchmark's camera (portbench/configs/disc_image_isco.json):
# dist 1e4, r_disc 30, Nx 1000, so 1001 x 1001 rays
ISCO_DIST, ISCO_HALF, ISCO_NX = 1e4, 30.0, 1000
# the fields the card must give bitwise: plane points, r and those made by
# + and * alone; the others may differ by ULPS of the host's value (Q: _q_allowed)
EXACT = ("t", "r", "k", "h", "rdot_sign", "thetadot_sign", "alpha", "beta")
ULPS = 4
# rays whose float32 march start (every marched field) differs, per inclination
F32_STARTS_CHANGED = {30.0: 0, 45.0: 0, 60.0: 0, 75.0: 0, 80.0: 0}


def _f32_starts(rays, spin):
    """The float32 march's start buffers for the disc_image_isco launch, as
    int32 bit patterns."""
    from raytrace_tpu_torch.destinations import DiscWithISCO
    from raytrace_tpu_torch.geometry import isco_radius
    from raytrace_tpu_torch.ops import StepControl, march_kernel
    from raytrace_tpu_torch.ops.redshift import redshift_start

    rays = redshift_start(rays, -spin, V=0.0, reverse=True)
    _, _, buf, _ = march_kernel.prepare(
        rays, -spin, method="rk45", dest=DiscWithISCO(isco_radius(spin), ISCO_HALF),
        r_max=1.1 * ISCO_DIST, steplim=100_000, ctrl=StepControl(), boundary=None,
        march_dtype=torch.float32)
    return torch.stack([buf[f].view(torch.int32) for f in march_kernel.F_FIELDS])


def _q_allowed(host, dev, ulps):
    """The gap allowed between two Q's: ``ulps`` of the size of its terms
    (Q = l_theta^2 - (a cos theta)^2 + (h / tan theta)^2 cancels), plus
    what the gap in theta carries through its cos and tan: dQ/dtheta =
    2 (h / tan)^2 / (sin cos) + 2 (a cos)^2 tan, whose 1 / (sin cos) is
    8.2 at an inclination of 80 degrees."""
    th, h = host.theta.cpu().numpy(), host.h.cpu().numpy()
    dth = np.abs(dev.theta.cpu().numpy() - th)
    hq, aq = (h / np.tan(th)) ** 2, (SPIN * np.cos(th)) ** 2
    scale = np.abs(host.Q.cpu().numpy()) + aq + hq
    carried = 2 * dth * (hq / np.abs(np.sin(th) * np.cos(th)) + aq * np.abs(np.tan(th)))
    return ulps * torch.finfo(F64).eps * scale + carried


@pytest.mark.cuda
@pytest.mark.parametrize("incl", sorted(F32_STARTS_CHANGED))
def test_card_camera_matches_the_host_camera(incl):
    """The disc_image_isco camera on the card against the host's: plane
    points, r and the exact fields bitwise; theta, phi and the momenta
    within ULPS relative; Q within ``_q_allowed``; the float32 march starts
    changed on F32_STARTS_CHANGED rays."""
    card = _card()
    step = 2 * ISCO_HALF / ISCO_NX
    grid = ImagePlaneGrid.from_steps(-ISCO_HALF, ISCO_HALF, step, -ISCO_HALF, ISCO_HALF, step)
    assert grid.n_rays == 1_002_001
    host = image_plane(ISCO_DIST, incl, grid, SPIN, device="cpu", work_dtype=torch.float32)
    with _HostWork() as seen:
        dev = image_plane(ISCO_DIST, incl, grid, SPIN, device=card, work_dtype=torch.float32)
    assert seen.ops == []
    eps = torch.finfo(F64).eps
    for f in PLANE_FIELDS:
        a, b = getattr(dev, f).cpu().numpy(), getattr(host, f).numpy()
        if f in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "Q":
            assert (np.abs(a - b) <= _q_allowed(host, dev, ULPS)).all()
        else:
            np.testing.assert_allclose(a, b, rtol=ULPS * eps, atol=0, err_msg=f)
    changed = (_f32_starts(dev, SPIN) != _f32_starts(host.to(card), SPIN)).any(0)
    assert int(changed.sum()) == F32_STARTS_CHANGED[incl]


@pytest.mark.cuda
def test_card_bundles_match_the_host_bundles():
    """A small ``image_plane_bundles`` case on the card against the host,
    held as the camera above."""
    card = _card()
    grid = ImagePlaneGrid.from_steps(-10.0, 10.0, 0.5, -10.0, 10.0, 0.5)
    host, eps_h = image_plane_bundles(1e4, 60.0, grid, SPIN, device="cpu")
    dev, eps_d = image_plane_bundles(1e4, 60.0, grid, SPIN, device=card)
    assert eps_d == eps_h
    eps = torch.finfo(F64).eps
    for f in PLANE_FIELDS:
        a, b = getattr(dev, f).cpu().numpy(), getattr(host, f).numpy()
        if f in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "Q":
            assert (np.abs(a - b) <= _q_allowed(host, dev, ULPS)).all()
        else:
            np.testing.assert_allclose(a, b, rtol=ULPS * eps, atol=0, err_msg=f)
