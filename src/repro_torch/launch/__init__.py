"""repro_torch.launch — device meshes for the sharded GLCM
(``core.distributed``); ``mesh`` builds them over ``torch.distributed``."""

from repro_torch.launch import mesh

__all__ = ["mesh"]
