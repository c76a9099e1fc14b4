"""Device meshes for ``repro_torch.core.distributed``.

Counterpart of ``repro.launch.mesh``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, made by
``init_device_mesh``. Both functions expect an initialized process group
(``torch.distributed.init_process_group`` with its store, world size and
rank); the mesh's dims take the world's ranks in row-major order, so rank
``r`` of a (4, 2) ("data", "model") mesh sits at (r // 2, r % 2).

``make_production_mesh`` and ``required_devices`` of the reference describe
the TPU pod of the LM substrate and come with that slice of the port.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_compat_mesh", "make_host_mesh"]


def make_compat_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` with dims named ``axes`` over the world's ranks,
    for tensors on ``device_type`` (the group's backend decides where the
    collectives move data: NCCL on the card, gloo through the host)."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(shape=(2, 2), axes=("data", "model")) -> DeviceMesh:
    """A CPU mesh, for a gloo world (tests, and ranks that share one card)."""
    return make_compat_mesh(shape, axes, device_type="cpu")
