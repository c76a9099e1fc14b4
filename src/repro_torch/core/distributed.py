"""Distributed GLCM over ``torch.distributed`` — the paper's Scheme 3 at
mesh scale: "K blocks, one GPU" becomes "K ranks of a device mesh".

Counterpart of ``repro.core.distributed``. The input is sharded along its
leading spatial axis over one or more named dims of a
``torch.distributed.device_mesh.DeviceMesh`` — image ROWS for 2-D specs,
volume DEPTH for ``ndim=3`` specs. Each rank:

  1. copies its own block of the leading axis to ``device``;
  2. sends the top ``halo`` leading slices of its block to the previous rank
     and receives its own halo from the next one (``batch_isend_irecv``) —
     the paper's Pad rows as a boundary exchange; ``halo`` is the offset's
     leading delta (dy for images, dz for volumes). The last rank's halo is
     the ``-1`` sentinel, which votes nowhere and so handles the input's
     trailing edge;
  3. counts the private partial GLCM of its extended block through the
     backend's ``local_partial`` hook (``core.backends``): one
     ``glcm_fused`` launch for a 2-D shard and one ``glcm_volume`` launch
     for a depth slab on the card (one for a rank's whole batch of them in
     :func:`glcm_sharded_batch`), the one-hot version on the CPU;
  4. merges the partials with one ``all_reduce``.

Every pair is owned by the rank that holds its associate element, so a pair
crossing a block boundary is counted once. In-plane deltas never cross
ranks. The counts are exact int32.

Region specs (``region="tiles" | "window"``) shard the WINDOW GRID instead:
rank r of n owns grid rows [r·g0/n, (r+1)·g0/n) and reads the image rows
those windows cover (blocks overlap when windows do). Every window is whole
on one rank, so there is no halo and no sum; the rank counts its windows
through the backend's region path (``glcm_window`` on the card, the patch
fallback into ``glcm_volume`` for 3-D tiles).

The multi-controller contract
-----------------------------
* Every rank of the mesh calls the function, with the same arguments and
  the **global** input: a CPU tensor or a numpy array, which may be a
  ``np.load(..., mmap_mode="r")`` memmap.
* A rank moves only its own block of the leading axis to ``device``. Its
  halo comes from the next rank through the exchange; it never reads a
  neighbour's rows from its own copy of the input.
* The process group must be initialized and ``mesh`` built over it
  (``repro_torch.launch.mesh``). With a gloo group, halos and partials
  travel as CPU tensors (copied off and back onto the card); with any other
  backend (NCCL) they stay on the device.
* What a rank returns follows the reference's ``out_specs``: an output the
  reference sums with ``psum`` is whole on every rank — ``(L, L)`` from
  :func:`glcm_sharded`, ``(B/n_batch, L, L)`` from
  :func:`glcm_sharded_batch`, the same on every rank of a row group; an
  output the reference leaves sharded is this rank's block — the texture
  map's ``(g0/n, *grid_rest, L, L)`` or ``(B/n_batch, g0/n_rows, ..., L,
  L)``. Concatenating the blocks in mesh order gives the reference's global
  array. :func:`glcm_auto_sharded` returns whole outputs.

Tracing: with the port's tracer on (``repro_torch.obs.trace``), each stage
of a call is a span — ``distributed.block`` (read and copy to the device),
``distributed.halo``, ``distributed.partial``, ``distributed.regions``,
``distributed.reduce`` — closed only after the device finished the stage
(a synchronize, so a traced call serializes its stages), with the stage's
CUDA-event time as ``device_ms`` on the card. Off, the stages cost nothing.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import backends as _backends
from repro_torch.core.plan import compile_plan, resolve_device
from repro_torch.core.schemes import local_partial_nd
from repro_torch.core.spec import GLCMSpec
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "glcm_sharded",
    "glcm_sharded_batch",
    "glcm_auto_sharded",
    "local_partial_glcm",
    "local_partial_nd",
]


def _shard_plan(levels, d, theta, spec, shape, device):
    """Resolve the per-shard compute through the plan/backend layer.

    Legacy scalar args build a single-offset 2-D spec; an explicit ``spec``
    overrides them (and may be volumetric). The plan's backend must declare
    ``sharded_partial``; "auto" resolves to ``cuda_fused`` / ``cuda_volume``
    on the card and ``onehot`` on the CPU. Returns (plan, levels, offset)
    with ``offset`` the per-axis (dy, dx) / (dz, dy, dx) tuple.
    """
    if spec is None:
        if levels is None or d is None or theta is None:
            raise ValueError("pass either spec= or (levels, d, theta)")
        spec = GLCMSpec(levels=levels, pairs=((d, theta),), scheme="auto")
    else:
        if levels is not None or d is not None or theta is not None:
            raise ValueError("pass either spec= or (levels, d, theta), not both")
        if spec.quantize is not None or spec.symmetric or spec.normalize:
            raise ValueError(
                "sharded GLCM expects pre-quantized images and returns raw "
                "counts; quantize/symmetric/normalize must be unset in spec"
            )
    spec.single_pair()  # sharded compute is single-offset
    plan = compile_plan(spec, shape, require=("sharded_partial",), device=device)
    return plan, plan.spec.levels, plan.spec.offsets()[0]


def local_partial_glcm(
    ext: torch.Tensor, levels: int, dy: int, dx: int, local_h: int
) -> torch.Tensor:
    """2-D form of :func:`local_partial_nd`: partial GLCM of a row shard
    extended with ``dy`` halo rows."""
    return local_partial_nd(ext, levels, (dy, dx), local_h)


# ---------------------------------------------------------------------------
# Mesh axes, blocks and collectives
# ---------------------------------------------------------------------------


class _Axis(NamedTuple):
    """The ranks along one (possibly flattened) mesh axis that hold this
    rank's other coordinates: their group, their global ranks in linear
    order, and this rank's index among them."""

    group: object
    ranks: tuple[int, ...]
    index: int


# (world, mesh, axes) → _Axis of this rank. ``dist.new_group`` is collective —
# every rank creates every subgroup, in the same order — so a flattened axis
# makes its groups once per mesh of a world, on the first call that names it.
_GROUPS: dict = {}


def _axis_size(mesh, name: str) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(name)]


def _axis(mesh, axes: tuple[str, ...]) -> _Axis:
    """This rank's :class:`_Axis` over ``axes``, ordered by the linearized
    index over the listed axes with the first varying slowest (the
    reference's ``jax.lax.axis_index(axes)``)."""
    key = (dist.group.WORLD, mesh, axes)
    if key in _GROUPS:
        return _GROUPS[key]
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    others = [i for i in range(len(names)) if i not in dims]
    rows = mesh.mesh.permute(others + dims).reshape(-1, math.prod(
        mesh.mesh.shape[i] for i in dims)).tolist()
    # One named axis has its group in the mesh already; a flattened one
    # needs a group per row, which every rank must create.
    groups = ([mesh.get_group(axes[0])] * len(rows) if len(axes) == 1
              else [dist.new_group(row) for row in rows])
    me = dist.get_rank()
    found = [_Axis(g, tuple(row), row.index(me)) for g, row in zip(groups, rows) if me in row]
    if not found:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    found = found[0]
    _GROUPS[key] = found
    return found


def _on_host(group) -> bool:
    """gloo moves CPU tensors: halos and partials go through the host."""
    return dist.get_backend(group) == "gloo"


@contextlib.contextmanager
def _stage(name: str, device: torch.device, **attrs):
    """One stage of a sharded call as a tracer span (see the module
    docstring); nothing when tracing is off."""
    tr = _obs_trace.get_tracer()
    if not tr.enabled:
        yield
        return
    with tr.span(name, **attrs) as sp:
        if device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        sp.set(device_ms=start.elapsed_time(end))


def _take(img, index: tuple[slice, ...]) -> torch.Tensor:
    """``img[index]`` of the global input as a tensor where ``img`` lies,
    reading nothing else of it (a memmap reads only these pages)."""
    if torch.is_tensor(img):
        return img[index]
    block = np.asarray(img[index])
    with warnings.catch_warnings():
        # A read-only memmap: the block is only ever copied from.
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(block)


def _extended(img, index: tuple[slice, ...], lead: int, halo: int,
              device: torch.device) -> torch.Tensor:
    """``img[index]`` as int32 levels on ``device``, with ``halo`` more
    slices along axis ``lead``, left unset for the exchange to fill."""
    block = _take(img, index)
    shape = list(block.shape)
    n = shape[lead]
    shape[lead] += halo
    ext = torch.empty(shape, dtype=torch.int32, device=device)
    with _stage("distributed.block", device, bytes=block.numel() * block.element_size()):
        # Across devices in the block's own dtype, widened on the device: a
        # copy_ that changes both converts on the host first and moves 4x
        # the bytes of a uint8 block (3-8x slower on an H100).
        ext.narrow(lead, 0, n).copy_(block.to(device))
    return ext


def _exchange_halo(ext: torch.Tensor, lead: int, local_n: int, d0: int, ax: _Axis) -> None:
    """Fill ``ext``'s trailing ``d0`` slices along ``lead``: the next rank's
    top ``d0`` slices, or the -1 sentinel on the last rank. Sends this
    rank's top slices to the previous rank in the same batch of P2P ops."""
    if d0 == 0:
        return
    device = ext.device
    with _stage("distributed.halo", device, slices=d0):
        last = ax.index == len(ax.ranks) - 1
        tail = ext.narrow(lead, local_n, d0)
        host = _on_host(ax.group)
        ops = []
        if ax.index > 0:
            top = ext.narrow(lead, 0, d0).contiguous()
            ops.append(dist.P2POp(dist.isend, top.cpu() if host else top,
                                  ax.ranks[ax.index - 1], ax.group))
        if not last:
            recv = torch.empty(tail.shape, dtype=ext.dtype,
                               device="cpu" if host else device)
            ops.append(dist.P2POp(dist.irecv, recv, ax.ranks[ax.index + 1], ax.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if last:
            tail.fill_(-1)
        else:
            tail.copy_(recv)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, on ``t``'s device."""
    with _stage("distributed.reduce", t.device, elements=t.numel()):
        if _on_host(group):
            h = t.cpu()
            dist.all_reduce(h, group=group)
            return h.to(t.device)
        dist.all_reduce(t, group=group)
        return t


def _partial(plan, ext: torch.Tensor, levels: int, offset, local_n: int) -> torch.Tensor:
    with _stage("distributed.partial", ext.device, backend=plan.backend.name):
        return plan.backend.local_partial(ext, levels, offset, local_n)


def _region_rows(spec: GLCMSpec, per: int, r: int) -> slice:
    """The leading-axis rows of the input that grid rows [r·per, (r+1)·per)
    cover."""
    s0, r0 = spec.strides[0], spec.region_shape[0]
    return slice(r * per * s0, ((r + 1) * per - 1) * s0 + r0)


def _regions(plan, x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial) levels → (B, *grid, L, L) int32 per-region counts."""
    with _stage("distributed.regions", x.device, backend=plan.backend.name):
        return _backends.compute_regions(plan.backend, x, plan.spec)[..., 0, :, :]


def _check_halo(n0: int, n: int, d0: int) -> int:
    if n0 % n:
        raise ValueError(f"leading extent {n0} not divisible by {n} shards")
    local_n = n0 // n
    if d0 > local_n:
        raise ValueError(f"halo {d0} exceeds shard extent {local_n}")
    return local_n


def _check_grid(g0: int, n: int) -> int:
    if g0 % n:
        raise ValueError(f"region grid extent {g0} not divisible by {n} shards")
    return g0 // n


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def glcm_sharded(
    img,
    levels: int | None = None,
    d: int | None = None,
    theta: int | None = None,
    mesh=None,
    *,
    axis: str | tuple[str, ...] = "data",
    spec: GLCMSpec | None = None,
    device=None,
) -> torch.Tensor:
    """Exact GLCM of a single input sharded along its leading spatial axis
    over ``axis`` of ``mesh`` — image rows for 2-D, volume depth for ndim=3.

    Every rank passes the global input (see the module docstring). The
    per-shard compute is resolved through ``compile_plan`` (the backend must
    declare ``sharded_partial``); pass ``spec=`` for the spec-native API
    (volumetric specs over (D, H, W) volumes included) or the legacy
    ``(levels, d, theta)`` scalars. ``axis`` is a mesh dim name or a tuple
    of names, flattened with the first varying slowest. Returns the whole
    (L, L) int32 GLCM on ``device``, on every rank.

    With a region-structured ``spec`` the WINDOW GRID is sharded instead:
    its leading extent must divide evenly over the ranks, no halo is
    exchanged and nothing is summed; returns this rank's block of the
    (*grid, L, L) int32 texture map, (g0/n, *grid_rest, L, L).
    """
    if mesh is None:
        raise ValueError("glcm_sharded requires a mesh")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    device = resolve_device(device)
    shape = tuple(img.shape)
    plan, levels, offset = _shard_plan(levels, d, theta, spec, shape, device)
    if len(shape) != len(offset):
        # compile_plan accepts a (B, H, W) stack as a batched plan; here the
        # leading axis is the SHARDING axis, so a mis-ranked input must fail
        # loudly instead of sharding the wrong dimension.
        raise ValueError(
            f"glcm_sharded shards a single {len(offset)}-D input, got shape "
            f"{shape}; use glcm_sharded_batch for stacks"
        )
    n = math.prod(_axis_size(mesh, a) for a in axes)
    if plan.grid:
        per = _check_grid(plan.grid[0], n)
        ax = _axis(mesh, axes)
        x = _extended(img, (_region_rows(plan.spec, per, ax.index),), 0, 0, device)
        return _regions(plan, x[None])[0]
    d0 = offset[0]
    local_n = _check_halo(shape[0], n, d0)
    ax = _axis(mesh, axes)
    lo = ax.index * local_n
    ext = _extended(img, (slice(lo, lo + local_n),), 0, d0, device)
    _exchange_halo(ext, 0, local_n, d0, ax)
    return _all_reduce(_partial(plan, ext, levels, offset, local_n), ax.group)


def glcm_sharded_batch(
    imgs,
    levels: int | None = None,
    d: int | None = None,
    theta: int | None = None,
    mesh=None,
    *,
    batch_axis: str = "data",
    row_axis: str | None = "model",
    spec: GLCMSpec | None = None,
    device=None,
) -> torch.Tensor:
    """Exact GLCMs of a (B, H, W) / (B, D, H, W) stack sharded over the mesh.

    The batch axis is split over ``batch_axis`` (the serving layout:
    independent requests on independent ranks) and, when ``row_axis`` is
    given, the leading spatial axis of every input over ``row_axis``, with
    the same halo exchange as :func:`glcm_sharded`. ``row_axis=None`` keeps
    whole inputs per rank, whose trailing edge is ``d0`` sentinel slices.
    Returns this rank's (B/n_batch, L, L) int32 GLCMs, the same on every
    rank of its row group.

    With a region-structured ``spec`` the window grid's leading axis is
    split over ``row_axis`` instead (no halo, no sum); returns this rank's
    (B/n_batch, g0/n_rows, *grid_rest, L, L) block of the texture maps.
    """
    if mesh is None:
        raise ValueError("glcm_sharded_batch requires a mesh")
    device = resolve_device(device)
    shape = tuple(imgs.shape)
    plan, levels, offset = _shard_plan(levels, d, theta, spec, shape, device)
    nd = len(offset)
    if len(shape) != nd + 1:
        raise ValueError(
            f"expected a batched {nd + 1}-D stack for an ndim={nd} spec, got {shape}"
        )
    b = shape[0]
    n_batch = _axis_size(mesh, batch_axis)
    if b % n_batch:
        raise ValueError(f"batch {b} not divisible by {n_batch} shards")
    per_b = b // n_batch
    bi = mesh.get_local_rank(batch_axis)
    batch = slice(bi * per_b, (bi + 1) * per_b)
    n_rows = _axis_size(mesh, row_axis) if row_axis is not None else 1
    if plan.grid:
        per = _check_grid(plan.grid[0], n_rows)
        r = _axis(mesh, (row_axis,)).index if row_axis is not None else 0
        x = _extended(imgs, (batch, _region_rows(plan.spec, per, r)), 1, 0, device)
        return _regions(plan, x)
    d0 = offset[0]
    local_n = _check_halo(shape[1], n_rows, d0)
    ax = _axis(mesh, (row_axis,)) if row_axis is not None else None
    lo = ax.index * local_n if ax is not None else 0
    ext = _extended(imgs, (batch, slice(lo, lo + local_n)), 1, d0, device)
    if ax is not None:
        _exchange_halo(ext, 1, local_n, d0, ax)
    else:
        ext[:, local_n:].fill_(-1)  # the input's own trailing edge
    part = _partial(plan, ext, levels, offset, local_n)  # the rank's batch in one launch
    return _all_reduce(part, ax.group) if ax is not None else part


def glcm_auto_sharded(
    img,
    levels: int | None = None,
    d: int | None = None,
    theta: int | None = None,
    mesh=None,
    *,
    axis: str | tuple[str, ...] = "data",
    spec: GLCMSpec | None = None,
    device=None,
) -> torch.Tensor:
    """The cross-check of :func:`glcm_sharded`, after the reference's GSPMD
    variant: no point-to-point exchange. Each rank reads its block of the
    leading axis (rows [r·n0/n, (r+1)·n0/n), any n) plus the following
    ``d0`` slices straight from the global input — the gather GSPMD
    inserts — counts it through the plan's ordinary ``compute_regions``
    route and ``all_reduce``s. Agrees with :func:`glcm_sharded` only if both
    are right.

    Returns whole outputs on every rank: the (L, L) int32 GLCM, or for a
    region spec the whole (*grid, L, L) texture map (each rank counts its
    block of grid rows; the blocks are summed into place).
    """
    if mesh is None:
        raise ValueError("glcm_auto_sharded requires a mesh")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    device = resolve_device(device)
    shape = tuple(img.shape)
    plan, levels, offset = _shard_plan(levels, d, theta, spec, shape, device)
    if len(shape) != len(offset):
        raise ValueError(
            f"glcm_auto_sharded shards a single {len(offset)}-D input, got shape {shape}"
        )
    ax = _axis(mesh, axes)
    n, r = len(ax.ranks), ax.index
    if plan.grid:
        g0 = plan.grid[0]
        lo, hi = r * g0 // n, (r + 1) * g0 // n
        whole = torch.zeros(plan.grid + (levels, levels), dtype=torch.int32, device=device)
        if hi > lo:
            s0, r0 = plan.spec.strides[0], plan.spec.region_shape[0]
            x = _extended(img, (slice(lo * s0, (hi - 1) * s0 + r0),), 0, 0, device)
            whole[lo:hi] = _regions(plan, x[None])[0]
        return _all_reduce(whole, ax.group)
    n0, d0 = shape[0], offset[0]
    lo, hi = r * n0 // n, (r + 1) * n0 // n
    # The (L, L) counts and, last, how many ranks hold a cell past 2**24:
    # the one-hot schemes vote in float32, exact only below that. Summed
    # with the counts, so every rank raises, or none.
    counts = torch.zeros(levels * levels + 1, dtype=torch.int64, device=device)
    if hi > lo:
        x = _extended(img, (slice(lo, min(hi + d0, n0)),), 0, 0, device)
        with _stage("distributed.partial", device, backend=plan.backend.name):
            mats = _backends.compute_regions(plan.backend, x[None], plan.spec)[0, 0]
        counts[:-1] = mats.reshape(-1).to(torch.int64)
        counts[-1] = (mats >= 2**24).any()
    total = _all_reduce(counts, ax.group)
    if total[-1]:
        raise ValueError(
            "a cell of a rank's block reaches 2**24, past what float32 votes "
            "hold exactly; use glcm_sharded"
        )
    return total[:-1].reshape(levels, levels).to(torch.int32)
