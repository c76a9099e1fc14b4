"""The reference's parameters carried into the port.

The reference (``repro.models``) keeps parameters as nested dicts whose
layer groups are stacked on a leading axis (``group_{i}/attn/wq`` of shape
``(C, d, h, dh)``; whisper's ``encoder`` / ``decoder`` likewise). The port
keeps one module per layer in the same layout, so the conversion is a pure
renaming that unstacks those leaves: ``group_0/attn/wq[j]`` →
``group_0.{j}.attn.wq``. Anything it cannot map — an unknown path, a
missing one, a shape or dtype that differs — raises.

Input leaves are numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side); this module imports no JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from repro_torch.models.model import model_module

# Top-level reference keys whose leaves carry a stacked layer axis.
_STACKED = re.compile(r"^(group_\d+|encoder|decoder)$")


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)   # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_reference(cfg, tree: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for the reference parameter
    tree ``tree`` of ``cfg``."""
    want = model_module(cfg, device="meta").state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        top, _, rest = path.partition("/")
        if _STACKED.match(top) and rest:
            for j in range(arr.shape[0]):
                out[f"{top}.{j}.{rest.replace('/', '.')}"] = _tensor(arr[j])
        else:
            out[path.replace("/", ".")] = _tensor(arr)
    unknown = sorted(set(out) - set(want))
    missing = sorted(set(want) - set(out))
    if unknown or missing:
        raise KeyError(f"{cfg.name}: reference paths the port does not map: {unknown}; "
                       f"port parameters the tree lacks: {missing}")
    for k, t in out.items():
        if tuple(t.shape) != tuple(want[k].shape) or t.dtype != want[k].dtype:
            raise ValueError(f"{cfg.name}: {k} is {tuple(t.shape)} {t.dtype} in the reference, "
                             f"{tuple(want[k].shape)} {want[k].dtype} in the port")
    return out


def load_reference_params(model: nn.Module, tree: dict) -> nn.Module:
    """Copy the reference parameter tree into ``model`` (on its device)."""
    model.load_state_dict(params_from_reference(model.cfg, tree), strict=True)
    return model
