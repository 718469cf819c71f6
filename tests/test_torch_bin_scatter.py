"""The bins' masked scatter (``ops/reductions.py``, ``csrc/bins.cu``).

``masked_bins`` takes torch's ``index_add_`` on a CPU tensor, for a value
that carries a derivative and for an empty batch, and otherwise on a card
the scatter kernel: its block-local route for a few bins, its global route
for many; the kernel refuses what it does not take. The CPU cases hold the route choice, and hold
``masked_segment_sum``, ``radial_bin_profile`` and ``pixel_accumulate``
bitwise to an inline copy of the ``where`` + ``index_add_`` code they ran
before the kernel, gradients included. The cases marked ``cuda`` hold both
kernel routes to ``index_add_`` on the card (counts exactly, sums to rtol
1e-12), and the emissivity and disc-image ``compute`` to their
``index_add_`` route:
``python -m pytest --noconftest -m cuda tests/test_torch_bin_scatter.py``.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch.apps import emissivity, imageplane_disc_image  # noqa: E402
from raytrace_tpu_torch.ops import reductions  # noqa: E402
from raytrace_tpu_torch.ops.reductions import (  # noqa: E402
    bin_edges,
    bin_route,
    block_warps,
    carries_derivative,
    masked_segment_sum,
    pixel_accumulate,
    radial_bin_index,
    radial_bin_profile,
)
from raytrace_tpu_torch.sources import ImagePlaneGrid, PointSourceGrid  # noqa: E402
from raytrace_tpu_torch.utils import profiling  # noqa: E402

SPIN = 0.998
SOURCE = (0.0, 5.0, 1e-3, 1.5707)


# The scatter as it ran before the kernel, one where + index_add_ pass a column.
def _old_segment_sum(values, seg_ids, mask, n_bins):
    ids = torch.where(mask, seg_ids, n_bins)
    out = torch.zeros(n_bins + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, ids, torch.where(mask, values, torch.zeros_like(values)))
    return out[:n_bins]


def _old_radial(r, mask, weights, r_min, dr, n_bins, logbin):
    ids, in_range = radial_bin_index(r, r_min, dr, n_bins, logbin)
    m = mask & in_range
    counts = _old_segment_sum(torch.ones_like(r), ids, m, n_bins)
    return counts, {k: _old_segment_sum(v, ids, m, n_bins) for k, v in weights.items()}


def _old_pixels(ix, iy, mask, weights, nx, ny):
    m = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = ix.long() * ny + iy.long()

    def scatter(v):
        return _old_segment_sum(v, flat, m, nx * ny).reshape(nx, ny)

    dtypes = [v.dtype for v in weights.values()] or [torch.float64]
    dtype = functools.reduce(torch.promote_types, dtypes)
    counts = scatter(torch.ones(flat.shape, dtype=dtype, device=flat.device))
    return counts, {k: scatter(v) for k, v in weights.items()}


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


# (device, derivative, rays, bins, weights) -> route
ROUTES = [
    ("cpu", False, 1000, 100, 4, "index_add"),
    ("cpu", False, 1000, 1_000_000, 6, "index_add"),
    ("cuda", True, 1000, 100, 4, "index_add"),
    ("cuda", False, 0, 100, 4, "index_add"),
    ("cuda", False, 1000, 100, 4, "block"),
    ("cuda", False, 1000, 6144, 0, "block"),
    ("cuda", False, 1000, 6145, 0, "global"),
    ("cuda", False, 1000, 1_000_000, 6, "global"),
    ("cuda", False, 1000, 0, 4, "block"),
    ("cuda", False, 1000, 100, reductions.MAX_COLUMNS + 1, "block"),
]


@pytest.mark.parametrize("device,derivative,n,n_bins,k,route", ROUTES)
def test_bin_route(device, derivative, n, n_bins, k, route):
    """CPU, a derivative or no rays: ``index_add_``; on a card the
    emissivity's 100 bins x (count + 4 weights) take the block-local route,
    as does a count alone into 6,144 bins (one warp's copy fills 48 KB),
    and the image's 10^6 pixels x (count + 6) the global one. No bins or
    too many weights take the kernel too, which refuses them
    (``test_bin_scatter_refuses_what_it_does_not_take_on_cuda``)."""
    assert bin_route(torch.device(device), n, n_bins, k, derivative=derivative) == route


def test_block_warps_follow_the_bins():
    """Eight warp copies of 100 bins x 5 rows (32 KB) fit in a block's 48
    KB; fewer for more bins, down to one copy; none for the image."""
    assert block_warps(100, 4) == 8
    assert block_warps(1000, 4) == 1
    assert block_warps(6144, 0) == 1 and block_warps(6145, 0) == 0
    assert block_warps(1_000_000, 6) == 0


@pytest.mark.parametrize("warps,width,per_sm", [(8, 500, 7), (8, 100, 8), (1, 6144, 4),
                                                (4, 1000, 7), (2, 3000, 4)])
def test_blocks_per_sm_fill_one_wave(warps, width, per_sm):
    """The block-local grid's blocks an SM: the emissivity's 8 warps x 500
    bins (32,000 B) fit seven times in 228 KB, a narrow block eight times
    in 64 warps, one warp's 48 KB copy four times."""
    assert reductions.blocks_per_sm(warps, width) == per_sm
    assert per_sm * warps <= reductions.SM_WARPS
    assert per_sm * (warps * width * 8 + 1024) <= reductions.SM_SHARED_BYTES


def test_carries_derivative():
    """A tensor that records a gradient (with grad mode on), carries a
    forward-mode tangent or is wrapped by a ``torch.func`` transform
    carries a derivative; a plain one, or one under ``no_grad``, not."""
    x = torch.ones(4, dtype=torch.float64)
    w = x.clone().requires_grad_()
    assert not carries_derivative(x) and carries_derivative(w)
    with torch.no_grad():
        assert not carries_derivative(w)
    with torch.autograd.forward_ad.dual_level():
        assert carries_derivative(torch.autograd.forward_ad.make_dual(x, x))
    seen = []
    torch.func.jvp(lambda a: seen.append(carries_derivative(a)) or a * 2, (x,), (x,))
    assert seen == [True]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 700.0, n)
    r[::97] = np.nan  # NaN radii fall outside every bin
    mask = rng.random(n) < 0.7
    w = {"a": rng.standard_normal(n), "b": rng.uniform(0.1, 5.0, n), "c": np.full(n, np.nan)}
    w["c"][mask] = rng.standard_normal(mask.sum())  # NaN only where masked out
    return torch.from_numpy(r), torch.from_numpy(mask), {k: torch.from_numpy(v)
                                                         for k, v in w.items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_masked_segment_sum_is_bitwise_as_before(dtype):
    """On the CPU ``masked_segment_sum`` is the where + index_add_ pass, bit for bit."""
    r, mask, w = _rays(3000, 1)
    ids = (r.nan_to_num(0.0) / 10).long()
    ids[~mask] = 10**9  # masked rays' ids go nowhere
    m = mask & (ids < 50)
    v = w["a"].to(dtype)
    assert _same_bits(masked_segment_sum(v, ids, m, 50), _old_segment_sum(v, ids, m, 50))


@pytest.mark.parametrize("logbin", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radial_bin_profile_is_bitwise_as_before(logbin, dtype):
    """On the CPU, counts and every sum bit for bit the old route's, in
    the radii's dtype."""
    r, mask, w = _rays(5000, 2)
    r, w = r.to(dtype), {k: v.to(dtype) for k, v in w.items()}
    _, _, dr = bin_edges(1.2, 500.0, 60, logbin, device="cpu")
    counts, sums = radial_bin_profile(r, mask, w, 1.2, dr, 60, logbin)
    old_counts, old_sums = _old_radial(r, mask, w, 1.2, dr, 60, logbin)
    assert _same_bits(counts, old_counts) and counts.sum() > 0
    assert list(sums) == list(w)
    for k in w:
        assert _same_bits(sums[k], old_sums[k]), k


@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.float64), (torch.float32,) * 2])
def test_pixel_accumulate_is_bitwise_as_before(dtypes):
    """On the CPU, counts (in the weights' promoted dtype) and every image
    bit for bit the old route's, rays off the grid dropped."""
    rng = np.random.default_rng(3)
    n, nx, ny = 20_000, 37, 23
    ix = torch.from_numpy(rng.integers(-3, nx + 3, n))
    iy = torch.from_numpy(rng.integers(-3, ny + 3, n))
    mask = torch.from_numpy(rng.random(n) < 0.7)
    w = {"a": torch.from_numpy(rng.standard_normal(n)).to(dtypes[0]),
         "b": torch.from_numpy(rng.uniform(0.1, 5.0, n)).to(dtypes[1])}
    counts, images = pixel_accumulate(ix, iy, mask, w, nx, ny)
    old_counts, old_images = _old_pixels(ix, iy, mask, w, nx, ny)
    assert _same_bits(counts, old_counts) and counts.shape == (nx, ny)
    for k in w:
        assert _same_bits(images[k], old_images[k]), k
    # no weights: counts alone, in float64
    counts, images = pixel_accumulate(ix, iy, mask, {}, nx, ny)
    assert images == {} and _same_bits(counts, _old_pixels(ix, iy, mask, {}, nx, ny)[0])


def test_diff_binned_gradient_takes_index_add():
    """``ops/diff.py``'s binning: the emissivity weight 1/g^gamma of a
    gamma and a spin that record gradients, into bins whose inner edge is
    the spin's ISCO (a tensor). The weight carries a derivative, so the
    route is ``index_add_`` on a card too; the reverse and forward
    derivatives come out bit for bit the old route's."""
    from raytrace_tpu_torch.geometry import isco_radius

    rng = np.random.default_rng(4)
    n, n_r = 4000, 40
    r = torch.from_numpy(rng.uniform(1.0, 300.0, n))
    g0 = torch.from_numpy(rng.uniform(0.3, 1.5, n))
    mask = torch.from_numpy(rng.random(n) < 0.8)

    def observable(binning, gamma, spin):
        rmin = isco_radius(spin)
        _, _, dr = bin_edges(rmin, 300.0, n_r, True, device="cpu")
        g = torch.where(mask, g0 * (1 + spin) / 2, 1.0)
        weights = {"emis": 1.0 / g**gamma}
        assert bin_route(torch.device("cuda"), n, n_r, 1,
                         derivative=carries_derivative(weights["emis"])) == "index_add"
        counts, sums = binning(r, mask, weights, rmin, dr, n_r, True)
        return sums["emis"], counts

    gamma = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    spin = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    profiling.start()
    emis, counts = observable(radial_bin_profile, gamma, spin)
    rec = profiling.stop()
    assert [s[0] for s in rec.spans] == ["rt.bins", "rt.bins.index_add"]
    old_emis, old_counts = observable(_old_radial, gamma, spin)
    assert _same_bits(emis.detach(), old_emis.detach()) and _same_bits(counts, old_counts)
    grads = torch.autograd.grad(emis.sum(), (gamma, spin))
    old_grads = torch.autograd.grad(old_emis.sum(), (gamma, spin))
    assert all(_same_bits(a, b) for a, b in zip(grads, old_grads))
    assert all(torch.isfinite(a) and a != 0 for a in grads)
    tangent = [torch.func.jvp(lambda s: observable(f, gamma.detach(), s)[0],
                              (spin.detach(),), (torch.ones((), dtype=torch.float64),))[1]
               for f in (radial_bin_profile, _old_radial)]
    assert _same_bits(*tangent) and torch.isfinite(tangent[0]).all()


# ---- on the card ---------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the scatter kernel has no CPU build")


def _index_add(columns, ids, mask, n_bins):
    ones = torch.ones(ids.shape, dtype=torch.float64, device=ids.device)
    return torch.stack([masked_segment_sum(v, ids, mask, n_bins) for v in (ones, *columns)])


def _case(name, n, n_bins, k, seed):
    """Seeded ids, mask and k positive float64 columns on the card; the
    masked-out rays' ids and values are out of range and NaN."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_bins, n)
    mask = rng.random(n) < 0.6
    if name == "all masked":
        mask[:] = False
    elif name == "none masked":
        mask[:] = True
    elif name == "one hot bin":
        ids[:] = n_bins // 2
    elif name == "runs":  # neighbouring rays share bins, as the emissivity's do
        ids = np.minimum(np.arange(n) * n_bins // max(n, 1), n_bins - 1)
    cols = [rng.uniform(0.5, 2.0, n) * 10.0**c for c in range(k)]
    ids[~mask] = rng.choice([-1, n_bins, 2**62], (~mask).sum())
    for v in cols:
        v[~mask] = np.nan
    dev = "cuda"
    return ([torch.from_numpy(v).to(dev) for v in cols], torch.from_numpy(ids).to(dev),
            torch.from_numpy(mask).to(dev))


CASES = [("random", 100_003), ("all masked", 5000), ("none masked", 5000),
         ("one hot bin", 100_003), ("runs", 300_001), ("random", 1), ("random", 32 * 8 * 3 + 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("route,n_bins,k", [("block", 100, 4), ("block", 1000, 2),
                                             ("global", 1_000_000, 6)])
@pytest.mark.parametrize("name,n", CASES)
def test_kernel_routes_match_index_add_on_cuda(route, n_bins, k, name, n):
    """Each kernel route against ``index_add_`` of the same rays: counts
    exactly, sums to rtol 1e-12; the masked-out rays' out-of-range ids and
    NaN values are never read. One launch a scatter; the block-local
    route gives the same bits again."""
    _need_card()
    columns, ids, mask = _case(name, n, n_bins, k, seed=n + k)
    warps = block_warps(n_bins, k)
    assert bin_route(ids.device, n, n_bins, k) == route and (warps > 0) == (route == "block")
    before = reductions.launches
    out = reductions.bin_scatter(columns, ids, mask, n_bins, warps)
    assert reductions.launches == before + 1
    m = mask & (ids >= 0) & (ids < n_bins)
    want = _index_add(columns, torch.where(m, ids, 0), m, n_bins)
    torch.cuda.synchronize()
    assert out.shape == (k + 1, n_bins) and out.dtype == torch.float64
    assert torch.equal(out[0], want[0]) and out[0].sum().item() == m.sum().item()
    np.testing.assert_allclose(out[1:].cpu().numpy(), want[1:].cpu().numpy(), rtol=1e-12, atol=0)
    if route == "block":
        again = reductions.bin_scatter(columns, ids, mask, n_bins, warps)
        assert _same_bits(again, out)


@pytest.mark.cuda
def test_bin_scatter_refuses_what_it_does_not_take_on_cuda():
    """A CPU tensor, a float32 column, columns of another length, more
    than MAX_COLUMNS of them or no bins raise before any launch; so does
    ``masked_bins`` asked for counts in another dtype, and a float32
    profile or image on the card."""
    _need_card()
    columns, ids, mask = _case("random", 1000, 100, 2, seed=5)
    before = reductions.launches
    for bad in ([columns, ids.cpu(), mask.cpu()], [[columns[0].float()], ids, mask],
                [[columns[0][:10]], ids, mask],
                [columns * (reductions.MAX_COLUMNS // 2 + 1), ids, mask]):
        with pytest.raises(ValueError):
            reductions.bin_scatter(*bad, 100, 8)
    with pytest.raises(ValueError):
        reductions.bin_scatter(columns, ids, mask, 0, 8)
    with pytest.raises(ValueError):
        reductions.masked_bins(columns, ids, mask, 100, torch.float32)
    r = columns[0].float()
    with pytest.raises(ValueError):
        radial_bin_profile(r, mask, {"a": r}, 0.5, 2.0, 10, False)
    with pytest.raises(ValueError):
        pixel_accumulate(ids % 10, ids % 7, mask, {"a": r}, 10, 10)
    assert reductions.launches == before


def _index_add_route(monkeypatch):
    monkeypatch.setattr(reductions, "bin_route", lambda *a, **k: "index_add")


@pytest.mark.cuda
def test_emissivity_compute_matches_index_add_on_cuda(monkeypatch):
    """The emissivity table on the 0.05 grid: the scatter kernel's
    block-local route (one launch, its span under ``rt.bins``) against the
    ``index_add_`` route: counts equal, columns to rtol 1e-12."""
    _need_card()
    grid = PointSourceGrid.from_steps(0.05, 0.05)
    run = functools.partial(emissivity.compute, SPIN, SOURCE, grid=grid, device="cuda")
    before = reductions.launches
    profiling.start()
    out = run()
    rec = profiling.stop()
    assert reductions.launches == before + 1
    names = [s[0] for s in rec.spans]
    bins = names.index("rt.bins")
    assert [s[0] for s in rec.spans if s[1] == bins] == ["rt.bins.kernel"]
    assert "rt.bins.index_add" not in names
    with monkeypatch.context() as mp:
        _index_add_route(mp)
        ref = run()
    assert np.array_equal(out["rays"], ref["rays"]) and out["rays"].sum() > 0
    for c in ("flux", "emis", "redshift", "time"):
        np.testing.assert_allclose(out[c], ref[c], rtol=1e-12, atol=0, err_msg=c)


@pytest.mark.cuda
def test_disc_image_compute_matches_index_add_on_cuda(monkeypatch):
    """A 201 x 201 camera on a 200 x 200 image (the isco variant): the
    kernel's global route against the ``index_add_`` route: counts equal,
    maps to rtol 1e-12."""
    _need_card()
    grid = ImagePlaneGrid.from_steps(-15.0, 15.0, 0.15, -15.0, 15.0, 0.15)
    assert bin_route(torch.device("cuda"), 1, 200 * 200, 6) == "global"
    run = functools.partial(imageplane_disc_image.compute, SPIN, 1e4, 60.0, grid, r_disc=15.0,
                            img_nx=200, img_ny=200, variant="isco", steplim=30000, device="cuda")
    before = reductions.launches
    out = run()
    assert reductions.launches == before + 1
    with monkeypatch.context() as mp:
        _index_add_route(mp)
        ref = run()
    assert np.array_equal(out["counts"], ref["counts"]) and out["counts"].sum() > 0
    for c in out:
        np.testing.assert_allclose(out[c], ref[c], rtol=1e-12, atol=0, equal_nan=True,
                                   err_msg=c)
    assert math.isfinite(float(np.nansum(out["flux"])))


# ---- chip_smoke.py's bins phase, its plain-Python parts -------------------

# nvcc -Xptxas -v lines for two march kernels and the bins' three
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__366e562c_8_march_cu_0a23ae1c12march_kernelIfLi2ELi0EEEvN2rt6ParamsIT_EENS1_6FieldsIS3_EElPyS8_' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__366e562c_8_march_cu_0a23ae1c12march_kernelIfLi2ELi0EEEvN2rt6ParamsIT_EENS1_6FieldsIS3_EElPyS8_
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 0 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a24bin_scatter_block_kernelEPKlPKhNS_7ColumnsEiliPd' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a24bin_scatter_block_kernelEPKlPKhNS_7ColumnsEiliPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a25bin_scatter_reduce_kernelEPKdliPd' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a25bin_scatter_reduce_kernelEPKdliPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, used 1 barriers, 8448 bytes smem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a25bin_scatter_global_kernelEPKlPKhNS_7ColumnsEillPd' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__4870000a_7_bins_cu_1041466a25bin_scatter_global_kernelEPKlPKhNS_7ColumnsEillPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
"""


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_reads_the_scatter_kernels_registers():
    """``ptxas_kernels`` parses each kernel's registers, stack and spills;
    ``ptxas_lines`` names a march kernel by method, destination, dtype and
    schedule and each of the bins' kernels by its own name, in the order
    of their mangled names."""
    cs = _chip_smoke()
    kernels = cs.ptxas_kernels(PTXAS_LOG)
    assert sorted(k["regs"] for k in kernels.values()) == ["18", "24", "38", "94"]
    assert cs.ptxas_lines(PTXAS_LOG) == [
        "bin_scatter_block_kernel: 38 registers, stack 0 B, spill stores 0 B, loads 0 B",
        "bin_scatter_global_kernel: 24 registers, stack 0 B, spill stores 0 B, loads 0 B",
        "bin_scatter_reduce_kernel: 18 registers, stack 0 B, spill stores 0 B, loads 0 B",
        "rk45 x theta f32 (grid): 94 registers, stack 40 B, spill stores 0 B, loads 0 B",
    ]


def test_chip_smoke_keeps_the_scatter_inputs():
    """``scatter_inputs`` keeps the arguments of each ``masked_bins`` call
    that ``radial_bin_profile`` and ``pixel_accumulate`` make inside it,
    the results unchanged, and puts ``masked_bins`` back after."""
    cs = _chip_smoke()
    real = reductions.masked_bins
    r, mask, w = _rays(2000, 6)
    _, _, dr = bin_edges(1.2, 500.0, 30, True, device="cpu")
    want = radial_bin_profile(r, mask, w, 1.2, dr, 30, True)
    ix, iy = (r.nan_to_num(0) % 9).long(), (r.nan_to_num(0) % 5).long()
    with cs.scatter_inputs(reductions) as seen:
        got = radial_bin_profile(r, mask, w, 1.2, dr, 30, True)
        pixel_accumulate(ix, iy, mask, {"a": w["a"]}, 9, 5)
    assert reductions.masked_bins is real
    assert _same_bits(got[0], want[0]) and all(_same_bits(got[1][k], want[1][k]) for k in w)
    assert [(len(a[0]), a[3], a[4]) for a in seen] == [(3, 30, torch.float64),
                                                       (1, 45, torch.float64)]
    columns, ids, m, n_bins, dtype = seen[0]
    assert _same_bits(masked_segment_sum(columns[0], ids, m, n_bins), want[1]["a"])
