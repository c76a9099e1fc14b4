"""Streamed GLCM processing — the paper's Scheme 3 (CUDA streams and pinned
memory, Fig. 3), on real streams.

Counterpart of ``repro.core.pipeline``. The paper overlaps ``copy block k+1
(copyStream)`` with ``kernel block k (exeStream)``. The reference imitates
that through JAX's asynchronous dispatch; on the card :class:`GLCMStream`
does it as the paper does: ``prefetch`` pinned host staging buffers, each
host-to-device copy issued ``non_blocking`` on a side ``torch.cuda.Stream``,
one event per copy that the compute stream waits on, and one event per
result, the oldest of which is waited on before it is yielded. Depth 2 is
exactly the paper's double buffer; depth 1 is the synchronous baseline (an
item is copied only once the previous one has finished). On the CPU
(``device="cpu"``, which only the tests ask for) there is no pinning and no
side stream.

``glcm_feature_stream`` is the convenience wrapper: quantize → GLCM
(multi-offset) → Haralick-14 per image, overlapped with the next transfer.
Its program is resolved through ``core.plan.compile_plan``, one cached plan
per (spec, shape), shared with every other entry point.

Batching: ``glcm_feature_stream(..., batch_size=B)`` coalesces the incoming
images into fixed (B, H, W) stacks, one plan call each; results are still
yielded per image, in order, and the final partial stack is padded (its
padding results dropped) so that one shape is ever compiled.
``coalesce_images`` is the grouping helper.

Tracing: with the global tracer live (``repro_torch.obs.trace.get_tracer``,
read when a stream starts), each stack records a ``pipeline.coalesce`` span
around its ``np.stack`` (``images``); on the card each item copied from the
host records a ``pipeline.stage`` span around its copy into pinned memory,
the wait for the slot's previous copy included (``bytes``), and each result
a ``pipeline.join`` span around the wait for it: the host waiting on the
card. The plan call under them records its own ``plan.*`` spans. No span
synchronizes the device beyond what the stream already does; off, each is
the tracer's shared no-op.
"""

from __future__ import annotations

import collections
from collections.abc import Callable, Iterable, Iterator
from typing import Any

import numpy as np
import torch

from repro_torch.core.plan import compile_plan, resolve_device
from repro_torch.core.schemes import PAPER_PAIRS
from repro_torch.core.spec import GLCMSpec
from repro_torch.obs.trace import get_tracer

__all__ = ["GLCMStream", "glcm_feature_stream", "coalesce_images", "pad_stack"]


def pad_stack(images: list[np.ndarray], size: int) -> tuple[np.ndarray, int]:
    """Stack ``images`` padded up to ``size`` entries → (stack, n_valid).

    Padding repeats the last image (never a zeros tensor: padded slots run
    the same data-dependent work as real ones, so padded-launch timings are
    honest), marking how many leading entries are real.
    """
    k = len(images)
    if not 1 <= k <= size:
        raise ValueError(f"need 1..{size} images, got {k}")
    buf = [np.asarray(im) for im in images]
    buf.extend([buf[-1]] * (size - k))
    return np.stack(buf), k


def coalesce_images(
    images: Iterable[np.ndarray], batch_size: int
) -> Iterator[tuple[np.ndarray, int]]:
    """Group an image stream into (stack, n_valid) fixed-size batches.

    Every yielded stack has exactly ``batch_size`` images; a final partial
    group is padded by repeating its last image (n_valid marks how many
    leading entries are real), so downstream consumers see one shape.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    tr = get_tracer()
    buf: list[np.ndarray] = []
    for im in images:
        buf.append(np.asarray(im))
        if len(buf) == batch_size:
            with tr.span("pipeline.coalesce", images=batch_size):
                stack = np.stack(buf)
            yield stack, batch_size
            buf = []
    if buf:
        with tr.span("pipeline.coalesce", images=len(buf)):
            padded = pad_stack(buf, batch_size)
        yield padded


class _Staging:
    """One pinned host buffer and the event of the last copy out of it."""

    def __init__(self):
        self.host: torch.Tensor | None = None
        self.copied: torch.cuda.Event | None = None

    def fill(self, item: np.ndarray) -> torch.Tensor:
        """Copy ``item`` into the buffer (a host memcpy), once the previous
        copy out of it has completed; (re)allocate it for a new shape."""
        if self.copied is not None:
            self.copied.synchronize()
        src = torch.from_numpy(np.ascontiguousarray(item))
        if self.host is None or self.host.shape != src.shape or self.host.dtype != src.dtype:
            self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src)
        return self.host


class GLCMStream:
    """Depth-``prefetch`` pipelined map of ``fn`` over host arrays.

    ``fn`` takes a tensor on ``device`` (None: the card) and returns a
    tensor (or anything) there; results are yielded in order. At most
    ``prefetch`` items are in flight: ``prefetch=1`` is fully synchronous
    (the paper's non-stream baseline), ``prefetch=2`` the paper's double
    buffer. An item that already is a tensor on the device is not copied.
    """

    def __init__(
        self,
        fn: Callable[[torch.Tensor], Any],
        *,
        prefetch: int = 2,
        device=None,
    ):
        if prefetch < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.fn = fn
        self.prefetch = prefetch
        self.device = resolve_device(device)

    def __call__(self, images: Iterable[np.ndarray]) -> Iterator[Any]:
        if self.device.type == "cuda":
            return self._cuda(images)
        return self._cpu(images)

    def _cpu(self, images) -> Iterator[Any]:
        for host in images:
            yield self.fn(torch.as_tensor(np.asarray(host)))

    def _cuda(self, images) -> Iterator[Any]:
        dev = self.device
        tr = get_tracer()
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        slots = [_Staging() for _ in range(self.prefetch)]
        queue: collections.deque = collections.deque()
        it = iter(images)
        count = 0

        def enqueue() -> bool:
            nonlocal count
            try:
                item = next(it)
            except StopIteration:
                return False
            if torch.is_tensor(item) and item.device == dev:
                x = item
            else:
                slot = slots[count % self.prefetch]
                item = np.asarray(item)
                with tr.span("pipeline.stage", bytes=item.nbytes):
                    host = slot.fill(item)
                with torch.cuda.stream(copy):  # the paper's copyStream
                    x = torch.empty(host.shape, dtype=host.dtype, device=dev)
                    x.copy_(host, non_blocking=True)
                    slot.copied = torch.cuda.Event()
                    slot.copied.record(copy)
                compute.wait_event(slot.copied)
                # x was allocated on the copy stream and is used on the
                # compute stream: keep the allocator from reusing its memory
                # before the compute stream is done with it.
                x.record_stream(compute)
            with torch.cuda.stream(compute):  # the paper's exeStream
                out = self.fn(x)
                done = torch.cuda.Event()
                done.record(compute)
            queue.append((out, done))
            count += 1
            return True

        for _ in range(self.prefetch):
            if not enqueue():
                break
        while queue:
            out, done = queue.popleft()
            with tr.span("pipeline.join"):
                done.synchronize()  # the join point: the oldest result only
            enqueue()
            yield out


_UNSET = object()  # distinguishes "not passed" from an explicit vmin/vmax=None


def glcm_feature_stream(
    images: Iterable[np.ndarray],
    levels: int | None = None,
    pairs: tuple[tuple[int, int], ...] | None = None,
    *,
    spec: GLCMSpec | None = None,
    prefetch: int = 2,
    batch_size: int = 1,
    temporal_window: int | None = None,
    vmin: float | None | object = _UNSET,
    vmax: float | None | object = _UNSET,
    device=None,
) -> Iterator[torch.Tensor]:
    """Yield (len(pairs), 14) Haralick feature tensors per input image, on
    ``device`` (None: the card), with transfer/compute overlap.

    ``batch_size > 1`` coalesces the stream into (batch_size, H, W) stacks
    (one plan call per stack); results are unpacked and yielded per image in
    arrival order, so callers see the same protocol at any batch size.

    Pass a :class:`GLCMSpec` to pick scheme and quantization, or use the
    legacy ``levels``/``pairs``/``vmin``/``vmax`` keywords, which build the
    equivalent spec (uniform quantization pinned to [vmin, vmax], 0..255 by
    default). A region spec streams per-image texture maps, (gh, gw,
    len(pairs), 14) each; a volumetric spec (``spec.ndim == 3``) streams
    (D, H, W) volumes the same way.

    ``temporal_window=w`` switches to the incremental temporal mode: the
    input is one ordered video stream, and each yielded tensor is the
    Haralick features of the exact rolling w-frame window ending at that
    frame (one per-frame delta per step instead of w; see
    ``core.stream_state``). The stream is stateful and ordered, so
    ``batch_size`` must stay 1; frame k+1's copy still overlaps window k's
    update.
    """
    if spec is None:
        if levels is None:
            raise ValueError("pass either spec= or levels")
        vmin = 0.0 if vmin is _UNSET else vmin
        vmax = 255.0 if vmax is _UNSET else vmax
        vrange = None if (vmin is None and vmax is None) else (vmin, vmax)
        spec = GLCMSpec(
            levels=levels, pairs=PAPER_PAIRS if pairs is None else tuple(pairs),
            scheme="auto", quantize="uniform", vrange=vrange,
        )
    elif (levels is not None or pairs is not None
          or vmin is not _UNSET or vmax is not _UNSET):
        raise ValueError(
            "pass either spec= or the legacy levels/pairs/vmin/vmax keywords, not both"
        )
    device = resolve_device(device)

    if temporal_window is not None:
        if batch_size != 1:
            raise ValueError(
                "temporal_window streams are stateful and ordered; batch_size must be 1"
            )
        carry: dict = {}

        def step(frame: torch.Tensor) -> torch.Tensor:
            # Steps run in arrival order on one stream, so the state carries.
            if not carry:
                plan = compile_plan(spec, tuple(frame.shape), features=True,
                                    temporal_window=temporal_window, device=device)
                carry.update(plan=plan, state=plan.init_state())
            carry["state"], out = carry["plan"].update(carry["state"], frame)
            return out

        return GLCMStream(step, prefetch=prefetch, device=device)(images)

    def fn(img: torch.Tensor) -> torch.Tensor:
        # One cached plan per incoming shape, shared with glcm/glcm_features.
        return compile_plan(spec, tuple(img.shape), features=True, device=device)(img)

    if batch_size == 1:
        return GLCMStream(fn, prefetch=prefetch, device=device)(images)

    def unbatched() -> Iterator[torch.Tensor]:
        counts: collections.deque[int] = collections.deque()

        def stacks():
            for stack, k in coalesce_images(images, batch_size):
                counts.append(k)  # enqueue order == GLCMStream yield order
                yield stack

        for out in GLCMStream(fn, prefetch=prefetch, device=device)(stacks()):
            for i in range(counts.popleft()):
                yield out[i]

    return unbatched()
