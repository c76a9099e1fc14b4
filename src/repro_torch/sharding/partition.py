"""Sharding rules: param-path → PartitionSpec, plus batch/cache specs.

The port's counterpart of ``repro.sharding.partition``, with the same rules
and the same specs. The strategy on the production mesh (pod?, data, model):

  * batch        → ('pod', 'data')
  * Q sequence   → 'model'   (context parallelism; K/V are gathered inside
                              the attention layers)
  * d_ff         → 'model'
  * vocab        → 'model'   (padded to 128 multiples)
  * experts      → 'model'   (arctic)
  * FSDP (fsdp_params archs) → param d_model dims over 'data'; optimizer
    state inherits the same sharding
  * decode KV cache sequence → 'model'

Rules are matched on path SUFFIXES of the parameter tree and their tails
align to the LAST dims of the leaf: a reference leaf stacked over its layer
group (``group_0/attn/wq``, (C, d, h, dh)) pads its leading dim with None,
and the port's per-layer parameter (``group_0/3/attn/wq``, (d, h, dh)) takes
the same tail unpadded.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims:
axis names come from ``mesh_dim_names`` and sizes from ``mesh[name].size()``.
``named(mesh, tree)`` turns specs into :class:`NamedSharding`, whose
``placements`` are DTensor placements per mesh dim; :func:`distribute`
places a global tensor by one.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

__all__ = ["NamedSharding", "PartitionSpec", "batch_axes", "batch_size_divisor",
           "batch_specs", "cache_specs", "decode_token_specs", "distribute", "logits_spec",
           "named", "optimizer_state_specs", "param_specs", "spec_for_path"]

FSDP_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (unsharded), a mesh axis name, or
    a tuple of names (one dim over several mesh dims, row-major). A tuple of
    one name is stored as the name, as JAX's ``PartitionSpec`` stores it;
    missing trailing entries mean unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_names(mesh) -> tuple[str, ...]:
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dim names")
    return tuple(names)


def axis_size(mesh, entry) -> int:
    """The number of shards of a spec entry (None, a name, or names)."""
    if entry is None:
        return 1
    return math.prod(mesh[a].size() for a in (entry if isinstance(entry, tuple) else (entry,)))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def batch_size_divisor(mesh) -> int:
    return axis_size(mesh, batch_axes(mesh))


# (regex on path suffix) → spec tail — tails align to the LAST dims of the
# leaf; leading dims (the stacked layer axis) pad with None.
def _rules(cfg):
    fsdp = FSDP_AXIS if cfg.fsdp_params else None
    rep = cfg.replicate_params
    rules: list[tuple[str, tuple]] = [
        (r"embeddings/embed$", (MODEL_AXIS, fsdp)),          # (V, D)
        (r"embeddings/unembed$", (fsdp, MODEL_AXIS)),        # (D, V)
        (r"(^|/)meta$", (None, None)),
        # attention projections (wq/wk/wv: (D, H, Dh); wo: (H, Dh, D))
        (r"attn/w[qkv]$", (fsdp, None, None)),
        (r"attn/wo$", (None, None, fsdp)),
        # dense MLP
        (r"w_gate$|w_up$|w_in$", (fsdp, None if rep else MODEL_AXIS)),
        (r"w_down$|w_out$", (None if rep else MODEL_AXIS, fsdp)),
        # MoE experts (E, D, F) / (E, F, D); router stays replicated
        (r"moe/router$", (None, None)),
        # mamba: projections FSDP-shard their d_model-sized dim when the
        # arch is fsdp_params (hymba); everything else replicated.
        (r"mamba/(in_proj|out_proj)$", (fsdp, None)),
        (r"mamba/", ()),
        (r"conv_w$|conv_b$|A_log$|dt_bias$|gate_norm$", ()),
    ]
    if cfg.num_experts:
        if cfg.shard_experts:   # arctic: experts over model, d_model over data
            rules[5:5] = [
                (r"moe/w_gate$|moe/w_up$", (MODEL_AXIS, fsdp, None)),
                (r"moe/w_down$", (MODEL_AXIS, None, fsdp)),
            ]
        else:                   # mixtral: TP'd experts (d_ff over model)
            rules[5:5] = [
                (r"moe/w_gate$|moe/w_up$", (None, fsdp, MODEL_AXIS)),
                (r"moe/w_down$", (None, MODEL_AXIS, fsdp)),
            ]
    return rules


def spec_for_path(cfg, path: str, ndim: int) -> PartitionSpec:
    for pat, tail in _rules(cfg):
        if re.search(pat, path):
            tail = tuple(tail)[:ndim]
            pad = (None,) * (ndim - len(tail))
            return P(*(pad + tail))
    return P(*((None,) * ndim))  # replicated (norms, scalars, biases)


def param_specs(cfg, params) -> Any:
    """Nested dict of PartitionSpec by path. ``params`` is the port's module
    (per-layer paths ``group_0/3/attn/wq``, so each spec is its layer's) or
    a reference-layout nested dict of leaves with ``.shape`` (tensors,
    arrays, shape structs)."""
    if isinstance(params, nn.Module):
        flat = {name.replace(".", "/"): p for name, p in params.named_parameters()}
        out: dict = {}
        for path, p in flat.items():
            node = out
            *heads, last = path.split("/")
            for k in heads:
                node = node.setdefault(k, {})
            node[last] = spec_for_path(cfg, path, p.ndim)
        return out

    def walk(sub, prefix=""):
        out = {}
        for k, v in sub.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            else:
                out[k] = spec_for_path(cfg, path, len(v.shape))
        return out

    return walk(params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        names = _axis_names(self.mesh)
        used: list[str] = []
        for entry in self.spec:
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                if a not in names:
                    raise ValueError(f"{self.spec}: {a!r} is not a mesh axis of {names}")
                if a in used:
                    raise ValueError(f"{self.spec}: mesh axis {a!r} used twice")
                used.append(a)
            # DTensor shards one tensor dim over several mesh dims in mesh
            # order; GSPMD in the entry's order. Only equal orders agree.
            if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
                raise ValueError(f"{self.spec}: {axes} is not in the mesh's axis order {names}")

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
        ``d``'s entry names that mesh dim, else ``Replicate()``."""
        out = [Replicate()] * len(_axis_names(self.mesh))
        names = _axis_names(self.mesh)
        for d, entry in enumerate(self.spec):
            for a in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def check(self, shape) -> None:
        """Raise unless every sharded dim of ``shape`` divides by its mesh
        axes (GSPMD refuses uneven shards)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than {tuple(shape)} has dims")
        for d, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} ({shape[d]}) does not divide "
                                 f"by {n} shards ({self.spec})")


def named(mesh, tree):
    """``tree`` of specs → the same tree of :class:`NamedSharding`."""
    if isinstance(tree, PartitionSpec):
        return NamedSharding(mesh, tree)
    if isinstance(tree, dict):
        return {k: named(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(named(mesh, v) for v in tree)
    raise TypeError(f"not a PartitionSpec tree: {type(tree)}")


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """Place the global tensor ``x`` by ``sharding``: each rank keeps its
    own slice of ``x`` (every rank holds the same global value, so nothing
    is scattered), on the mesh's device type."""
    if isinstance(x, DTensor):
        raise TypeError("distribute takes a global tensor; reshard a DTensor through "
                        "train.fault_tolerance.reshard_tree")
    sharding.check(x.shape)
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


# ---------------------------------------------------------------------------
# Batch / cache / output specs per shape cell
# ---------------------------------------------------------------------------


def batch_specs(cfg, mesh, *, seq_shard: bool = True) -> dict:
    """Specs for a train/prefill batch dict."""
    ba = batch_axes(mesh)
    seq = MODEL_AXIS if seq_shard else None
    specs = {"tokens": P(ba, seq)}
    if cfg.embeds_input and not cfg.is_encoder_decoder:
        specs["embeds"] = P(ba, seq, None)
    if cfg.is_encoder_decoder:
        specs["enc_embeds"] = P(ba, seq, None)
    return specs


def decode_token_specs(cfg, mesh, batch_sharded: bool) -> tuple:
    ba = batch_axes(mesh) if batch_sharded else None
    return P(ba, None), P(ba)  # token (B,1), pos (B,)


def cache_specs(cfg, mesh, caches_tree, *, batch_sharded: bool) -> Any:
    """Specs for decode caches: KV sequence over 'model' (context layout) or
    KV heads over 'model' (heads_tp layout), batch over ('pod','data') when
    divisible (else replicated)."""
    ba = batch_axes(mesh) if batch_sharded else None
    heads_tp = cfg.attn_layout == "heads_tp"
    s_ax = None if heads_tp else MODEL_AXIS
    h_ax = MODEL_AXIS if heads_tp else None

    def leaf_spec(path: str, ndim: int) -> PartitionSpec:
        if re.search(r"(^|/)(k|v)$", path):        # (C, B, S, KV, Dh)
            return P(None, ba, s_ax, h_ax, None)
        if re.search(r"(^|/)(k|v)_scale$", path):  # (C, B, S, KV)
            return P(None, ba, s_ax, h_ax)
        if re.search(r"(^|/)(ck|cv)$", path):      # (L, B, T_enc, KV, Dh)
            return P(None, ba, s_ax, h_ax, None)
        if re.search(r"(^|/)pos$", path):          # (C, B, S)
            return P(None, ba, s_ax)
        if re.search(r"(^|/)mpos$", path):         # (B, T_enc)
            return P(ba, MODEL_AXIS)
        if re.search(r"(^|/)conv$", path):         # (C, B, K-1, CH)
            return P(None, ba, None, None)
        if re.search(r"(^|/)ssd$", path):          # (C, B, H, P, N)
            return P(None, ba, None, None, None)
        return P(*((None,) * ndim))

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}/{i}") for i, v in enumerate(node))
        return leaf_spec(prefix, len(node.shape))

    return walk(caches_tree)


def logits_spec(cfg, mesh, batch_sharded: bool = True) -> PartitionSpec:
    ba = batch_axes(mesh) if batch_sharded else None
    return P(ba, MODEL_AXIS)  # (B, padded_vocab): vocab TP'd


def optimizer_state_specs(param_spec_tree, opt_state_tree) -> Any:
    """Opt-state specs derived from param specs: moments inherit the param
    spec; adafactor factored stats drop the reduced dim's entry."""

    def walk(spec, st):
        if isinstance(st, dict) and set(st) == {"vr", "vc"}:
            s = tuple(spec)
            return {"vr": P(*s[:-1]), "vc": P(*(s[:-2] + s[-1:]))}
        if isinstance(st, dict) and set(st) == {"v"}:
            return {"v": spec}
        return spec

    def rec(spec_node, st_node):
        if isinstance(st_node, dict):
            if set(st_node) <= {"vr", "vc", "v"}:
                return walk(spec_node, st_node)
            return {k: rec(spec_node[k] if isinstance(spec_node, dict) else spec_node, v)
                    for k, v in st_node.items()}
        return spec_node

    out = {"step": P()}
    for key in opt_state_tree:
        if key == "step":
            continue
        out[key] = rec(param_spec_tree, opt_state_tree[key])
    return out
