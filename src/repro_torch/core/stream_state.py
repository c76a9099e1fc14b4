"""Incremental temporal GLCM: exact rolling-window co-occurrence state.

Counterpart of ``repro.core.stream_state``. Co-occurrence is a pure sum over
pixel pairs, so a rolling temporal window over a (T, H, W) video admits an
exact incremental update: frame t's window GLCM is frame t-1's plus the
arriving frame's per-frame vote delta minus the delta of the frame that just
left the window. Integer add and subtract are exact, so the incremental path
is bit-identical to a full recompute of the window — one frame-compute per
step instead of ``window``.

:class:`GLCMStreamState` is the explicit carry, four tensors on the plan's
device:

* ``counts`` — the accumulated window counts, **signed** int32 of shape
  (*grid, n_pairs, L, L) ((gh, gw, n_pairs, L, L) for region specs). The
  expiry subtraction of an unsigned width could transiently underflow.
* ``ring`` — the last ``window`` frames' per-frame deltas, (window, *grid,
  n_pairs, L, L) int32, so expiry subtracts a stored delta, never a
  recompute. It is allocated once, by :func:`init_state`, and updated in
  place (``index_copy_``): a texture-map stream's ring is gigabytes, too
  large to copy per frame. So a state is consumed by the step that takes
  it; step the state that step returns, not the old one again.
* ``pos`` — the ring slot the next update expires and overwrites.
* ``seen`` — total frames consumed (warm-up bookkeeping).

``pos`` and ``seen`` are 0-dim int32 tensors on the device and the ring is
indexed with ``index_select``/``index_copy_``, so a step never waits for the
card: frame k+1's copy overlaps window k's update.

Warm-up: the ring starts at zero, so for the first ``window`` frames the
expiry subtracts zero and ``counts`` is the exact sum over the frames seen so
far (a growing window until it fills).

Exactness bound: the per-frame delta is the plan's backend's int32 counts,
exact past 2²⁴ (the reference widens them to float32, which rounds a cell
past 2²⁴ = 16 777 216, e.g. a constant 4097 x 4098 frame at d = 1). The
accumulated int32 cell is bounded by ``window`` times the per-frame pair
count, and so is exact below 2³¹. Count-only outputs are these int32
counts; normalize and features give float32.

:class:`GLCMStreamPlan` is what ``core.plan.compile_plan`` returns for
``temporal_window=``: ``init_state()`` / ``update(state, frame)`` (the delta
reuses the plan's fused quantize→vote path, CUDA kernels included) /
``rolling(video)`` (a loop of ``update`` over the T frames, the counterpart of
the reference's ``lax.scan``), with normalize / symmetric / Haralick applied
lazily on the accumulated counts. Checkpoints: ``state_dict`` /
``from_state_dict`` and ``save`` / ``load`` (npz). ``state_struct()`` gives
the carry's shapes and dtypes as ``meta`` tensors, allocating nothing: the
plan-contract analyzer's ``stream-signed-accum`` rule reads it
(``repro_torch.analysis``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

__all__ = ["GLCMStreamPlan", "GLCMStreamState", "init_state", "stream_step"]


@dataclasses.dataclass(frozen=True)
class GLCMStreamState:
    """The rolling-window carry (see the module docstring for the fields)."""

    counts: torch.Tensor  # (*grid, n_pairs, L, L) signed int32
    ring: torch.Tensor    # (window, *grid, n_pairs, L, L) signed int32
    pos: torch.Tensor     # () int32, next slot to expire and overwrite
    seen: torch.Tensor    # () int32, frames consumed so far

    @property
    def window(self) -> int:
        return int(self.ring.shape[0])

    # -- checkpoint/resume -------------------------------------------------

    def state_dict(self) -> dict[str, np.ndarray]:
        """Host-side snapshot (numpy arrays; npz-friendly keys)."""
        return {k: getattr(self, k).cpu().numpy() for k in ("counts", "ring", "pos", "seen")}

    @classmethod
    def from_state_dict(cls, state: dict, device=None) -> GLCMStreamState:
        """Rebuild the state on ``device`` (None: the card) from
        :meth:`state_dict` output; dtypes are re-pinned to signed int32."""
        from repro_torch.core.plan import resolve_device

        dev = resolve_device(device)
        return cls(**{
            k: torch.as_tensor(np.asarray(state[k]), device=dev).to(torch.int32)
            for k in ("counts", "ring", "pos", "seen")
        })

    def save(self, path) -> None:
        np.savez(path, **self.state_dict())

    @classmethod
    def load(cls, path, device=None) -> GLCMStreamState:
        with np.load(path) as data:
            return cls.from_state_dict({k: data[k] for k in data.files}, device=device)


def init_state(
    window: int, grid: tuple[int, ...], n_pairs: int, levels: int, device=None
) -> GLCMStreamState:
    """A zeroed carry for a ``window``-frame stream of (*grid, n_pairs, L, L)
    per-frame count deltas, on ``device`` (None: the card)."""
    from repro_torch.core.plan import resolve_device

    dev = resolve_device(device)
    cell = tuple(grid) + (n_pairs, levels, levels)
    zeros = lambda shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
    return GLCMStreamState(counts=zeros(cell), ring=zeros((window,) + cell),
                           pos=zeros(()), seen=zeros(()))


def stream_step(state: GLCMStreamState, delta: torch.Tensor, window: int) -> GLCMStreamState:
    """One exact rolling-window update: add the arriving frame's ``delta``,
    subtract the expiring slot's stored delta, and store ``delta`` in that
    slot of the ring, in place. No value is read back to the host."""
    slot = state.pos.reshape(1).to(torch.int64)
    counts = torch.add(state.counts, delta)
    counts.sub_(state.ring.index_select(0, slot)[0])
    state.ring.index_copy_(0, slot, delta.to(torch.int32)[None])
    pos = torch.remainder(state.pos + 1, window).to(torch.int32)
    return GLCMStreamState(counts=counts, ring=state.ring, pos=pos, seen=state.seen + 1)


@dataclasses.dataclass(frozen=True)
class GLCMStreamPlan:
    """An incremental temporal GLCM program for one frame shape.

    Built by ``core.plan.compile_plan(spec, frame_shape,
    temporal_window=w)``. ``shape`` is the frame's spatial shape ((H, W) or
    (D, H, W); streams carry no batch axis, one plan per stream shape).
    ``delta_fn(frame) -> (*grid, n_pairs, L, L) int32`` is the per-frame
    partial-counts contract (the plan's quantize→vote path on a unit batch);
    ``tail_fn`` applies symmetric/normalize/Haralick lazily on the
    accumulated counts. Frames move to ``device`` and so does the state.
    """

    spec: object
    backend: object
    shape: tuple[int, ...]
    window: int
    features: bool | tuple[str, ...]
    delta_fn: Callable[[torch.Tensor], torch.Tensor]
    tail_fn: Callable[[torch.Tensor], torch.Tensor]
    device: torch.device
    grid: tuple[int, ...] = ()
    fused_quantize: bool = False
    host_native: bool = False
    tuned: object = None  # the autotune.TunedChoice applied, if any
    lint: tuple | None = None  # the lint verdict (Findings), once linted

    def update_fn(
        self, state: GLCMStreamState, frame: torch.Tensor
    ) -> tuple[GLCMStreamState, torch.Tensor]:
        """state × frame → (state', counts-or-features)."""
        state = stream_step(state, self.delta_fn(frame), self.window)
        return state, self.tail_fn(state.counts)

    def init_state(self) -> GLCMStreamState:
        return init_state(self.window, self.grid, self.spec.n_pairs, self.spec.levels,
                          device=self.device)

    def state_struct(self) -> GLCMStreamState:
        """The carry's shapes and dtypes as ``meta`` tensors (nothing is
        allocated): counts (*grid, n_pairs, L, L), ring (window, *grid,
        n_pairs, L, L), pos and seen (), all int32."""
        cell = tuple(self.grid) + (self.spec.n_pairs, self.spec.levels, self.spec.levels)
        meta = lambda shape: torch.empty(shape, dtype=torch.int32, device="meta")  # noqa: E731
        return GLCMStreamState(counts=meta(cell), ring=meta((self.window,) + cell),
                               pos=meta(()), seen=meta(()))

    def update(self, state: GLCMStreamState, frame) -> tuple[GLCMStreamState, torch.Tensor]:
        """One online step: consume ``frame``, return the advanced state and
        the window's counts/features. ``state`` is consumed (its ring is
        updated in place)."""
        x = torch.as_tensor(frame, device=self.device)
        if tuple(x.shape) != self.shape:
            raise ValueError(
                f"expected a {self.shape} frame for this stream plan, got {tuple(x.shape)}"
            )
        return self.update_fn(state, x)

    def rolling(self, video, *, init: GLCMStreamState | None = None, return_state: bool = False):
        """Offline (T, *spatial) stack → (T, …) per-step outputs, the state
        carried on the device across all T steps. Pass ``init=`` to resume a
        checkpointed stream; ``return_state=True`` also returns the final
        carry."""
        video = torch.as_tensor(video, device=self.device)
        if video.ndim != len(self.shape) + 1 or tuple(video.shape[1:]) != self.shape:
            raise ValueError(
                f"expected a (T, {', '.join(map(str, self.shape))}) video for this "
                f"stream plan, got {tuple(video.shape)}"
            )
        state = self.init_state() if init is None else init
        outs = []
        for frame in video:
            state, out = self.update_fn(state, frame)
            outs.append(out)
        outs = torch.stack(outs)
        return (outs, state) if return_state else outs

    def __call__(self, video) -> torch.Tensor:
        return self.rolling(video)
