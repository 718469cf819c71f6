"""Ray-axis data parallelism over ``torch.distributed``.

Counterpart of ``raytrace_tpu/parallel/sharding.py``. Rays never
communicate, so the parallel layer is pure data parallelism over one axis:
each rank (one process, one card) marches a contiguous block of the batch,
and the only collectives merge per-rank histograms, images or gradients
(one ``all_reduce(SUM)``) or bring a marched batch back to full width
(``all_gather``). Where JAX writes ``shard_map`` over a ``rays`` mesh axis
and ``psum``, each rank here runs the same code on its own block and calls
the collective itself; rank r of n holds the rays device r of JAX's mesh
holds under ``P("rays")``.

Ranks on cards talk over NCCL, one rank a card (NCCL refuses two ranks on
one card). On the CPU, and for several ranks sharing one card, the group is
gloo: it carries ``all_reduce`` and ``broadcast`` of CUDA tensors, but not
``all_gather``, which ``_all_gather`` then stages through host copies
itself. A process that has not initialised ``torch.distributed`` is a world
of one: every function below runs on its own and calls no collective.

Launch one process a card with ``torchrun --nproc-per-node=<cards>`` (it
sets the rendezvous and ``LOCAL_RANK`` in the environment, and
``auto_mesh()`` joins that group), or initialise the group yourself
(``init_process_group("nccl", init_method="tcp://localhost:<port>",
world_size=..., rank=...)``) and call ``make_ray_mesh()``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from raytrace_tpu_torch.ops import trace_auto
from raytrace_tpu_torch.ops.integrate import StepControl
from raytrace_tpu_torch.ops.reductions import radial_bin_profile
from raytrace_tpu_torch.ops.redshift import apply_redshift, range_phi, redshift_start
from raytrace_tpu_torch.rays import BOOL_FIELDS, FLOAT_FIELDS, INT_FIELDS, RayBatch
from raytrace_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ray axis over the ranks of a process group: the group (None for
    a world of one without ``torch.distributed``), this process's rank,
    the number of ranks and the device this rank marches on."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_ray_mesh(n_devices: int | None = None, *, group=None, device=None) -> RayMesh:
    """The mesh of this process: the default process group (or ``group``)
    when ``torch.distributed`` is initialised, else a world of one.
    ``device`` names this rank's device: ``cuda:<local rank>`` by default
    (``LOCAL_RANK`` as torchrun sets it, else the rank, modulo the cards
    visible) and for a bare "cuda"; "cpu" for the CPU. ``n_devices``, when
    given, must equal the number of ranks."""
    if dist.is_available() and dist.is_initialized():
        group = group or dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the mesh spans the group's {size} rank(s), not {n_devices}; "
                         "pass a group of that size")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' for the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return RayMesh(group=group, rank=rank, size=size, device=device)


def auto_mesh(device=None) -> RayMesh | None:
    """A mesh over every rank when this process is one of a world larger
    than one, else None: the apps' sharding hook, as JAX's
    ``device_count() > 1``. A process that ``torchrun`` started
    (``WORLD_SIZE`` > 1 in the environment) and that has not initialised
    ``torch.distributed`` joins the group torchrun describes (``env://``):
    NCCL when ``device`` is a card (the default), gloo for the CPU. On a
    card the rank's device becomes the current one."""
    if not dist.is_available():
        return None
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        kind = torch.device("cuda" if device is None else device).type
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_ray_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        return mesh
    return None


def _pad_tail(a, pad, edge: bool):
    """``a`` with ``pad`` more rows at the end: zeros, or the last value
    (for quantities that must stay in their finite domain)."""
    if edge:
        return torch.cat([a, a[-1:].expand(pad)])
    return torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)])


def pad_rays(rays: RayBatch, multiple: int) -> RayBatch:
    """The batch padded with dead rays (zeros, steps = -1) to a multiple
    of the rank count; a dead ray is never marched and falls out of every
    reduction."""
    n = rays.n_rays
    pad = -n % multiple
    if pad == 0:
        return rays
    padded = rays.replace(**{f.name: _pad_tail(getattr(rays, f.name), pad, edge=False)
                             for f in dataclasses.fields(rays)})
    steps = padded.steps.clone()
    steps[n:] = -1
    return padded.replace(steps=steps)


def _pad_angles(cosalpha, beta, dead, multiple: int):
    """Flat emission-angle tensors padded to a multiple of the rank count:
    the padding rows take the edge angles (so the constants of motion stay
    finite) and are flagged ``dead``, the angle twin of ``pad_rays``."""
    pad = -cosalpha.shape[0] % multiple
    if pad == 0:
        return cosalpha, beta, dead
    return (_pad_tail(cosalpha, pad, edge=True), _pad_tail(beta, pad, edge=True),
            torch.cat([dead, torch.ones(pad, dtype=torch.bool, device=dead.device)]))


def _block(a, mesh: RayMesh):
    """This rank's contiguous block of the leading axis of ``a``, on its
    device; the length must divide evenly."""
    n = a.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks; pad them first")
    per = n // mesh.size
    return a[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def shard_rays(rays: RayBatch, mesh: RayMesh) -> RayBatch:
    """This rank's contiguous block of the batch on its device: the rays
    that ``P("rays")`` gives device ``mesh.rank`` of a JAX mesh."""
    return rays.replace(**{f.name: _block(getattr(rays, f.name), mesh)
                           for f in dataclasses.fields(rays)})


def _all_reduce(x, mesh: RayMesh):
    """The sum of ``x`` over the ranks (``x`` itself in a world of one)."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _all_gather(x, mesh: RayMesh):
    """The ranks' equal-length ``x`` laid end to end, in rank order, on
    this rank's device. gloo gathers no CUDA tensor, so a gloo group gathers
    host copies of them."""
    if mesh.group is None:
        return x
    host = x.is_cuda and dist.get_backend(mesh.group) == "gloo"
    part = x.cpu() if host else x
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(parts, part.contiguous(), group=mesh.group)
    return torch.cat(parts).to(x.device)


def _gather_rays(rays: RayBatch, mesh: RayMesh) -> RayBatch:
    """Every rank's block, gathered to full width on this rank: one
    ``all_gather`` for the float fields, one for the counters and one for
    the gates (as bytes). A world of one has nothing to gather."""
    if mesh.group is None:
        return rays
    floats = _all_gather(torch.stack([getattr(rays, f) for f in FLOAT_FIELDS], 1), mesh)
    ints = _all_gather(torch.stack([getattr(rays, f) for f in INT_FIELDS], 1), mesh)
    gates = _all_gather(torch.stack([getattr(rays, f) for f in BOOL_FIELDS], 1).to(torch.uint8),
                        mesh)
    upd = {f: floats[:, i] for i, f in enumerate(FLOAT_FIELDS)}
    upd.update({f: ints[:, i] for i, f in enumerate(INT_FIELDS)})
    upd.update({f: gates[:, i].bool() for i, f in enumerate(BOOL_FIELDS)})
    return rays.replace(**{k: v.contiguous() for k, v in upd.items()})


def sharded_trace(
    rays: RayBatch,
    spin,
    mesh: RayMesh,
    *,
    method: str = "rk45",
    dest=None,
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    boundary=None,
    march_dtype=None,
) -> RayBatch:
    """March this rank's shard (``shard_rays``) and return it: each rank
    marches its own rays, with no collective. The march is ``trace_auto``
    on the shard's device, so the kernel (with ``kernel_steplim``) on a
    CUDA rank and the plain march otherwise, as the JAX ``_shard_engine``
    picks the Pallas kernel or the XLA loop. ``march_dtype`` is
    ``trace_auto``'s."""
    del mesh  # the shard is already this rank's; no collective
    return trace_auto(rays, spin, march_dtype=march_dtype, method=method, dest=dest,
                      r_max=r_max, steplim=steplim, ctrl=ctrl, boundary=boundary)


def sharded_emissivity_bins(
    rays: RayBatch,
    spin,
    mesh: RayMesh,
    *,
    V=0.0,
    r_min,
    dr,
    n_r: int,
    logbin_r: bool = True,
    gamma=2.0,
    n_primary=1.0,
    method: str = "rk45",
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
):
    """The emissivity step on this rank's shard (``shard_rays`` of the
    lamppost batch, before ``redshift_start``): march, redshift and radial
    bins, then one ``all_reduce`` of the counts and sums stacked together.
    The hit criterion and the weights are the app's own
    (``apps.emissivity.disc_hit_mask`` / ``emissivity_bin_weights``).
    Returns (counts, {flux, emis, redshift, time}), the same on every
    rank."""
    from raytrace_tpu_torch.apps.emissivity import disc_hit_mask, emissivity_bin_weights

    with span("rt.redshift"):
        shard = redshift_start(rays, spin, V)
    out = sharded_trace(shard, spin, mesh, method=method, r_max=r_max, steplim=steplim,
                        ctrl=ctrl)
    with span("rt.redshift"):
        out = apply_redshift(range_phi(out), spin, V=-1.0)
    counts, sums = radial_bin_profile(
        out.r, disc_hit_mask(out, spin), emissivity_bin_weights(out, gamma, n_primary),
        r_min, dr, n_r, logbin_r)
    merged = _all_reduce(torch.stack([counts, *sums.values()]), mesh)
    return merged[0], dict(zip(sums, merged[1:]))


def sharded_disc_image(
    rays: RayBatch,
    spin,
    mesh: RayMesh,
    *,
    grid,
    r_disc,
    img_nx: int,
    img_ny: int,
    variant: str = "plain",
    dest=None,
    theta_lim=math.pi / 2,
    r_isco=None,
    q1=3.0,
    rb1=4.0,
    q2=3.0,
    rb2=10.0,
    q3=3.0,
    flip_image: bool = True,
    method: str = "rk45",
    r_max=1000.0,
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    march_dtype=None,
):
    """The disc-image step over the mesh: ``rays`` is the whole camera
    batch (every rank builds the same one); each rank pads it, takes its
    shard, marches it backwards (spin negated; ``march_dtype`` is
    ``trace_auto``'s) and accumulates its pixels
    (``apps.imageplane_disc_image.accumulate_image_maps``), then one
    ``all_reduce`` merges the counts and the six maps. Returns (counts,
    {flux, r, phi, enshift, time, emis}), not divided by the counts, the
    same on every rank."""
    from raytrace_tpu_torch.apps.imageplane_disc_image import accumulate_image_maps
    from raytrace_tpu_torch.geometry import isco_radius

    if r_isco is None:
        r_isco = isco_radius(spin)
    shard = shard_rays(pad_rays(rays, mesh.size), mesh)
    a_trace = -spin  # time reversal (imageplane.cpp:12)
    with span("rt.redshift"):
        shard = redshift_start(shard, a_trace, V=0.0, reverse=True)
    out = sharded_trace(shard, a_trace, mesh, method=method, dest=dest, r_max=r_max,
                        steplim=steplim, ctrl=ctrl, march_dtype=march_dtype)
    counts, images = accumulate_image_maps(
        out, spin, grid, r_disc, img_nx, img_ny, variant=variant, dest=dest,
        theta_lim=theta_lim, r_isco=r_isco, q1=q1, rb1=rb1, q2=q2, rb2=rb2, q3=q3,
        flip_image=flip_image)
    merged = _all_reduce(torch.stack([counts, *images.values()]), mesh)
    return merged[0], dict(zip(images, merged[1:]))


def sharded_caustic_trace(
    rays: RayBatch,
    spin,
    mesh: RayMesh,
    *,
    dest=None,
    r_max=1000.0,
    method: str = "rk45",
    steplim: int | None = None,
    ctrl: StepControl = StepControl(),
    march_dtype=None,
) -> RayBatch:
    """The caustic bundles' march over the mesh: ``rays`` is the whole
    bundle batch (every rank builds the same one, ``spin`` the propagation
    spin, already negated); each rank pads it, marches its shard, and the
    shards are gathered back to full width on every rank, the padding
    stripped, for the host's Jacobians. The bundles need not share a
    rank: the differences are taken after the gather."""
    n = rays.n_rays
    shard = shard_rays(pad_rays(rays, mesh.size), mesh)
    out = sharded_trace(shard, spin, mesh, method=method, dest=dest, r_max=r_max,
                        steplim=steplim, ctrl=ctrl, march_dtype=march_dtype)
    return _gather_rays(out, mesh)[:n]


def _parameters(values, like):
    """Fresh leaf tensors of ``like``'s dtype and device that record a
    gradient, one for each value."""
    return [torch.tensor(float(v), dtype=like.dtype, device=like.device).requires_grad_(True)
            for v in values]


def sharded_emissivity_gradient(
    spin,
    h_source,
    gamma,
    grid,
    mesh: RayMesh,
    *,
    n_steps: int = 2048,
    r0=5.0,
    sigma_ln=0.3,
    r_max=500.0,
):
    """Value and d/d(spin, h, gamma) of the smooth emissivity observable
    (``ops.diff.emissivity_observable_from_angles``) with the lamppost
    grid's rays split over the mesh: each rank takes the value and the
    three derivatives of its own rays by autograd, then one
    ``all_reduce`` sums the four, in float64. Returns (value, (d_spin, d_h,
    d_gamma)) as 0-d tensors, the same on every rank."""
    from raytrace_tpu_torch.ops.diff import emissivity_observable_from_angles
    from raytrace_tpu_torch.sources import grid_angles

    angles = _pad_angles(*grid_angles(grid, device=mesh.device, dtype=torch.float64), mesh.size)
    cosalpha, beta, dead = (_block(a, mesh) for a in angles)
    params = _parameters((spin, h_source, gamma), cosalpha)
    value = emissivity_observable_from_angles(*params, cosalpha, beta, dead, n_steps=n_steps,
                                              r0=r0, sigma_ln=sigma_ln, r_max=r_max)
    grads = torch.autograd.grad(value, params)
    merged = _all_reduce(torch.stack([value.detach(), *grads]), mesh)
    return merged[0], tuple(merged[1:])


def sharded_line_profile_fit_step(
    spin,
    incl_deg,
    grid,
    target,
    mesh: RayMesh,
    *,
    dist=500.0,
    r_disc=50.0,
    q=3.0,
    e_rest=1.0,
    n_energies: int = 48,
    sigma_e=0.035,
    n_steps: int = 2048,
):
    """One line-profile fitting step over the mesh: the loss
    sum((P - target)^2) of the observed profile P(E; spin, incl) against
    ``target`` (its ``n_energies`` points over 0.3..1.3 e_rest), and
    d(loss)/d(spin, incl).

    The camera's rays split over the ranks. The loss is nonlinear in the
    total profile, so each rank computes its partial profile with a graph,
    the partials are summed (``all_reduce``, detached), and each rank
    backpropagates the loss's cotangent 2 (P - target) through its own
    partial; a second ``all_reduce`` sums the parameter gradients. Nothing
    is divided by the rank count: the JAX step divides by it to undo
    ``shard_map``'s transpose of its replicated loss, which this
    composition never builds. The loss and the gradients are those of one
    process that differentiates the same composition over every ray.
    Returns (loss, (d_spin, d_incl)) as float64 0-d tensors, the same on
    every rank."""
    from raytrace_tpu_torch.ops.diff import line_profile_from_xy

    x, y = grid.xy(device=mesh.device, dtype=torch.float64)
    dead = torch.zeros(x.shape, dtype=torch.bool, device=mesh.device)
    x, y, dead = (_block(a, mesh) for a in _pad_angles(x, y, dead, mesh.size))
    energies = torch.linspace(0.3 * e_rest, 1.3 * e_rest, n_energies, dtype=torch.float64,
                              device=mesh.device)
    target = torch.as_tensor(target, dtype=torch.float64, device=mesh.device)
    params = _parameters((spin, incl_deg), x)
    partial = line_profile_from_xy(*params, x, y, dead, dist=dist, r_disc=r_disc, q=q,
                                   e_rest=e_rest, energies=energies, sigma_e=sigma_e,
                                   n_steps=n_steps)
    total = _all_reduce(partial.detach().clone(), mesh)
    loss = torch.sum((total - target) ** 2)
    grads = torch.autograd.grad(partial, params, grad_outputs=2.0 * (total - target))
    merged = _all_reduce(torch.stack(grads), mesh)
    return loss, tuple(merged)
