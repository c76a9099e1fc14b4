"""Device meshes for ``repro_torch.core.distributed`` and the sharded LM.

Counterpart of ``repro.launch.mesh``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, made by
``init_device_mesh``. Every function expects an initialized process group
(``torch.distributed.init_process_group`` with its store, world size and
rank); the mesh's dims take the world's ranks in row-major order, so rank
``r`` of a (4, 2) ("data", "model") mesh sits at (r // 2, r % 2).

``make_production_mesh`` gives the LM's production meshes: one pod of 256
devices as (16, 16) ("data", "model"), or two as (2, 16, 16) ("pod",
"data", "model"), where "pod" is pure data parallelism. It is a function,
so importing this module touches no process group.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.gloo_cuda import route_functional_collectives

__all__ = ["make_compat_mesh", "make_host_mesh", "make_production_mesh", "required_devices"]


def make_compat_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` with dims named ``axes`` over the world's ranks,
    for tensors on ``device_type`` (the group's backend decides where the
    collectives move data: NCCL on the card, gloo through the host). A CUDA
    mesh over a gloo world routes DTensor's functional collectives through
    the c10d calls (``sharding.gloo_cuda``)."""
    mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    if device_type == "cuda" and dist.get_backend() == "gloo":
        route_functional_collectives()
    return mesh


def make_host_mesh(shape=(2, 2), axes=("data", "model")) -> DeviceMesh:
    """A CPU mesh, for a gloo world (tests, and ranks that share one card)."""
    return make_compat_mesh(shape, axes, device_type="cpu")


def required_devices(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) production mesh over an initialized world
    of exactly :func:`required_devices` ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = required_devices(multi_pod=multi_pod), dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of {need} ranks, "
                         f"not {world}")
    return make_compat_mesh(shape, axes, device_type=device_type)
