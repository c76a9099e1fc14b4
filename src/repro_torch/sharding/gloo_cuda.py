"""DTensor's collectives on CUDA tensors over a gloo world.

DTensor moves shards with the functional collectives
(``torch.ops._c10d_functional``). Over gloo, with the tensors on the card,
the functional ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
kill the process (SIGSEGV; torch 2.11, CUDA 12.8, NVIDIA H100), while the
c10d calls (``dist.all_gather_into_tensor``, ``dist.reduce_scatter_tensor``)
carry the same tensors over the same group. That is how the card runs
several gloo ranks sharing one device: NCCL refuses two ranks on one card.

:func:`route_functional_collectives` re-registers the CUDA kernels of the
functional collectives DTensor issues to call the c10d ones, synchronously
(the result is ready when the op returns, so ``wait_tensor`` has nothing to
wait for). It changes no value: each op computes what its own kernel would.
``launch.mesh.make_compat_mesh`` installs it when it builds a CUDA mesh over
a gloo world. The routing is process-wide: from then on every functional
collective on CUDA tensors goes through these functions, whatever its
group. So each refuses a group whose backend is not gloo
(``RuntimeError``): an NCCL group in a process that routed would otherwise
run its collectives synchronously through c10d without a word. CPU
tensors keep their kernels.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group

__all__ = ["ROUTED", "route_functional_collectives"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}
_lib: torch.library.Library | None = None

# The functional ops rerouted, as the chip run's probe line names them.
ROUTED = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
          "all_to_all_single")


def _gloo_group(group_name: str):
    """The group named ``group_name``; it must be a gloo group."""
    group = _resolve_process_group(group_name)
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise RuntimeError(
            f"the functional collectives of this process are routed through c10d for a "
            f"CUDA mesh over gloo (sharding.gloo_cuda); a {backend!r} group cannot use "
            f"them: run its mesh in a process that builds no CUDA mesh over gloo")
    return group


def _reduce(t: torch.Tensor, reduce_op: str, group, size: int, fn) -> torch.Tensor:
    if reduce_op == "avg":     # gloo has no AVG: a sum, then the mean
        return fn(t, dist.ReduceOp.SUM, group).div_(size)
    return fn(t, _OPS[reduce_op], group)


def _all_gather_into_tensor(inp, group_size, group_name):
    group = _gloo_group(group_name)
    out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
    return out


def _reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
    group = _gloo_group(group_name)

    def run(t, op, g):
        out = t.new_empty((t.shape[0] // group_size,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(), op=op, group=g)
        return out
    return _reduce(inp, reduce_op, group, group_size, run)


def _all_reduce(inp, reduce_op, group_name):
    group = _gloo_group(group_name)

    def run(t, op, g):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=g)
        return out
    return _reduce(inp, reduce_op, group, dist.get_world_size(group), run)


def _all_to_all_single(inp, output_split_sizes, input_split_sizes, group_name):
    group = _gloo_group(group_name)
    rows = sum(output_split_sizes) if output_split_sizes else inp.shape[0]
    out = inp.new_empty((rows,) + tuple(inp.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(), list(output_split_sizes) or None,
                           list(input_split_sizes) or None, group=group)
    return out


def _route(dispatch_key: str) -> tuple[str, ...]:
    global _lib
    if _lib is None:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        for name, fn in zip(ROUTED, (_all_gather_into_tensor, _reduce_scatter_tensor,
                                     _all_reduce, _all_to_all_single)):
            lib.impl(name, fn, dispatch_key)
        _lib = lib
    return ROUTED


def route_functional_collectives() -> tuple[str, ...]:
    """Route the functional collectives' CUDA kernels through the c10d
    calls (once per process); returns the names of the ops routed."""
    return _route("CUDA")
