"""The reference's parameters carried into the port, and back.

The reference (``repro.models``) keeps parameters as nested dicts whose
layer groups are stacked on a leading axis (``group_{i}/attn/wq`` of shape
``(C, d, h, dh)``; whisper's ``encoder`` / ``decoder`` likewise). The port
keeps one module per layer in the same layout, so the conversion is a pure
renaming that unstacks those leaves: ``group_0/attn/wq[j]`` →
``group_0.{j}.attn.wq``. Anything it cannot map — an unknown path, a
missing one, a shape or dtype that differs — raises.

Input leaves are numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side); this module imports no JAX.

The inverse, :func:`reference_groups`, gathers a module's per-layer
parameters under their reference path (``group_0.{j}.attn.wq`` → the ``j``-th
entry of ``group_0/attn/wq``): the reference's leaf view, which the
optimizer updates over (``train.optimizer``) and the checkpoints store
(:func:`reference_tree`, :func:`load_reference_tree`).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from repro_torch.models.model import model_module

# Top-level reference keys whose leaves carry a stacked layer axis.
_STACKED = re.compile(r"^(group_\d+|encoder|decoder)$")
# A per-layer parameter name of the port: top key, layer index, the rest.
_PER_LAYER = re.compile(r"^(group_\d+|encoder|decoder)\.(\d+)\.(.+)$")


def flatten_paths(tree: dict, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, paths joined by "/"."""
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flatten_paths(v, p)
        else:
            yield p, v


def nest_paths(flat: dict) -> dict:
    """The inverse of :func:`flatten_paths`: {"a/b": x} → {"a": {"b": x}}."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


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
    for path, leaf in flatten_paths(tree):
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


def reference_groups(model: nn.Module) -> dict[str, list[tuple[str, torch.Tensor]]]:
    """The reference's leaf view of ``model``: each reference path with the
    (name, parameter) pairs that make its leaf, in layer order. A stacked
    leaf (``group_0/attn/wq``) lists one parameter per layer of its group;
    any other (``embeddings/embed``) lists the one parameter it is. Paths
    come in the reference's flattening order (sorted keys at every level)."""
    groups: dict[str, list[tuple[int, str, torch.Tensor]]] = {}
    stacked: set[str] = set()
    for name, p in model.named_parameters():
        m = _PER_LAYER.match(name)
        if m:
            path = f"{m.group(1)}/{m.group(3).replace('.', '/')}"
            stacked.add(path)
            groups.setdefault(path, []).append((int(m.group(2)), name, p))
        else:
            groups.setdefault(name.replace(".", "/"), []).append((0, name, p))
    out = {}
    for path in sorted(groups, key=lambda q: q.split("/")):
        entries = sorted(groups[path], key=lambda e: e[0])
        if path in stacked and [e[0] for e in entries] != list(range(len(entries))):
            raise ValueError(f"{path}: layers {[e[0] for e in entries]} are not 0..C-1")
        out[path] = [(n, p) for _, n, p in entries]
    return out


def is_stacked(path: str) -> bool:
    """Whether the reference leaf at ``path`` carries a stacked layer axis."""
    top, _, rest = path.partition("/")
    return bool(_STACKED.match(top) and rest)


@torch.no_grad()
def reference_tree(model: nn.Module) -> dict:
    """``model``'s parameters as the reference's nested dict: stacked leaves
    are new tensors (``torch.stack`` of the layers), the rest the parameters
    themselves, detached."""
    return nest_paths({
        path: (torch.stack([p.detach() for _, p in ps]) if is_stacked(path)
               else ps[0][1].detach())
        for path, ps in reference_groups(model).items()})


@torch.no_grad()
def load_reference_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Copy a reference-layout tree of tensors (or arrays) into ``model``'s
    parameters in place, on their device: the inverse of
    :func:`reference_tree`. Paths, shapes and dtypes must match."""
    flat = dict(flatten_paths(tree))
    groups = reference_groups(model)
    if set(flat) != set(groups):
        raise KeyError(f"{model.cfg.name}: tree and model paths differ: "
                       f"{sorted(set(flat) ^ set(groups))[:5]}")
    for path, ps in groups.items():
        leaf = flat[path]
        leaf = leaf if torch.is_tensor(leaf) else _tensor(np.asarray(leaf))
        parts = leaf.unbind(0) if is_stacked(path) else (leaf,)
        if len(parts) != len(ps):
            raise ValueError(f"{path}: {len(parts)} layers in the tree, {len(ps)} in the model")
        for part, (name, p) in zip(parts, ps):
            if tuple(part.shape) != tuple(p.shape) or part.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(part.shape)} {part.dtype} in the tree, "
                                 f"{tuple(p.shape)} {p.dtype} in the model")
            p.copy_(part)
    return model
