"""repro_torch.launch — device meshes for the sharded GLCM
(``core.distributed``) and the sharded LM (``mesh`` builds them over
``torch.distributed``), the train steps (``steps``) and the serving and
training entry points (``serve``, ``train``)."""

from repro_torch.launch import mesh

__all__ = ["mesh"]
