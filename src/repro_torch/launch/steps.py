"""Step factories and abstract input specs for every (arch × shape) cell.

The port's counterpart of ``repro.launch.steps``. ``build_cell(cfg, cell,
mesh)`` returns what the dry run (and the real launchers) need: a step
callable, its arguments at their global shapes, and in/out
:class:`~repro_torch.sharding.partition.NamedSharding`. Shapes follow the
assignment:

  train_4k     train_step(params, opt_state, batch)      seq 4096,  B 256
  prefill_32k  prefill_step(params, batch)               seq 32768, B 32
  decode_32k   serve_step(params, caches, token, pos)    KV 32768,  B 128
  long_500k    serve_step with KV 524288, B 1            (sub-quadratic only)

Nothing is allocated here: the arguments are fake tensors under an active
``FakeTensorMode`` and ``meta`` tensors otherwise. ``params`` is the
parameter module (``models.model_module``); its shardings, like the
reference's, are a tree over the reference's layout (stacked layer groups,
``models.convert.reference_groups``), and a per-layer parameter takes its
leaf's spec without the stacked dim. ``lower_cell`` is the counterpart of
``jax.jit(...).lower``: it runs the program once on the rank's fake shards
and returns its costs (``launch.cost``).

``train_step(params, opt_state, batch)`` differentiates ``api.loss`` with
``torch.autograd`` and updates the parameters and the optimizer state in
place under ``torch.no_grad`` (the port's counterpart of the reference's
``donate_argnums``); it frees the gradients (``set_to_none``) and returns
``(params, opt_state, metrics)`` with ``loss``, ``nll``, ``aux``,
``grad_norm`` and ``lr``. With ``cfg.grad_accum > 1`` the batch is split
into that many microbatches, microbatch ``i`` being the global rows
``[i·B/accum, (i+1)·B/accum)`` as in the reference, whose gradients are
summed in the parameters' dtype, each scaled by 1/accum. A batch may come
already split, as ``(accum, B/accum, ...)`` leaves (3-D tokens): that is how
a mesh takes it (``split_batch``), each microbatch placed by the
reference's batch specs, so no rank moves rows to another. So a
``grad_accum > 1`` train cell takes its batch as ``(accum, B/accum, T)``
with ``P(None, *batch_spec)`` where the reference takes ``(B, T)`` with
``batch_spec``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.shapes import ShapeCell
from repro_torch.models import build_model, encdec, transformer
from repro_torch.models.common import dtype_of
from repro_torch.models.convert import is_stacked, reference_groups, reference_tree
from repro_torch.models.model import model_module
from repro_torch.sharding import partition as shd
from repro_torch.sharding.logical import default_rules, logical_axis_rules
from repro_torch.sharding.partition import NamedSharding, P
from repro_torch.train.optimizer import make_optimizer

__all__ = ["DECODE_T_ENC", "CellProgram", "abstract_params", "accumulate_grads",
           "build_cell", "lower_cell", "make_train_step", "micro_grads", "place_args",
           "run_program", "split_batch"]

# Static stub length of the encoder memory for enc-dec decode cells
# (whisper's real encoder emits 1500 frames; a 128-multiple is used).
DECODE_T_ENC = 4096


@dataclasses.dataclass
class CellProgram:
    name: str
    fn: Callable
    args: tuple                 # global shapes: fake or meta tensors, the params module
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()  # arguments the program updates in place
    rules: dict | None = None   # logical-axis rules active while it runs


def _cell_rules(cfg, mesh) -> dict:
    """The logical-axis rules of ``cfg`` on ``mesh``: ``default_rules``, with
    the heads_tp layout's flip (sequence unsharded, heads over "model")."""
    rules = default_rules(mesh)
    if cfg.attn_layout == "heads_tp":
        rules["seq"] = None
        rules["kv_seq"] = None
        rules["heads"] = "model"
    return rules


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def split_batch(batch: dict, accum: int) -> dict:
    """A global batch's leaves ``(B, ...)`` as ``(accum, B/accum, ...)``:
    microbatch ``i`` is rows ``[i·B/accum, (i+1)·B/accum)``."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if t.shape[0] % accum:
            raise ValueError(f"batch {k} of {t.shape[0]} rows does not split into {accum}")
        out[k] = t.reshape((accum, t.shape[0] // accum) + tuple(t.shape[1:]))
    return out


def _row(t: torch.Tensor, i: int) -> torch.Tensor:
    """``t[i]`` along an unsharded leading dim; a DTensor keeps its other
    dims' placements (each rank takes its own shard's row)."""
    if not isinstance(t, DTensor):
        return t[i]
    if any(p.is_shard(0) for p in t.placements):
        raise ValueError("the microbatch dim of a split batch must not be sharded")
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in t.placements]
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl, run_check=False)


def micro_grads(api, params, batch: dict, accum: int):
    """For each of ``accum`` microbatches of ``batch`` (global rows, or split
    already: 3-D tokens, see :func:`split_batch`), yield its loss (detached)
    and ``{name: gradient}`` (a parameter the loss does not reach is left
    out)."""
    if np.ndim(batch["tokens"]) == 2:
        if isinstance(batch["tokens"], DTensor):
            raise ValueError("a batch on a mesh comes split into microbatches (split_batch)")
        batch = split_batch({k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
                             .to(api.device) for k, v in batch.items()}, accum)
    named = list(params.named_parameters())
    for i in range(accum):
        mb = {k: _row(v, i) for k, v in batch.items()}
        loss, _ = api.loss(params, mb)
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        yield loss.detach(), {k: g for (k, _), g in zip(named, gs) if g is not None}


def accumulate_grads(api, params, batch: dict, accum: int):
    """``(loss, {name: gradient})`` of ``accum`` microbatches as the
    reference's scan sums them: each gradient scaled by 1/accum and summed in
    its parameter's dtype, the loss averaged in float32."""
    n = torch.tensor(accum, dtype=torch.float32, device=api.device)
    grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
    loss = torch.zeros((), dtype=torch.float32, device=api.device)
    for mloss, gs in micro_grads(api, params, batch, accum):
        for k, g in gs.items():
            grads[k] = grads[k] + (g / n).to(grads[k].dtype)
        loss = loss + mloss / n
    return loss, grads


def make_train_step(cfg, total_steps: int = 100_000, *, device=None):
    """``(train_step, opt_init)`` for ``cfg`` on ``device`` (default: the card)."""
    api = build_model(cfg, device=device)
    ocfg, oinit, oupdate = make_optimizer(cfg.optimizer, total_steps=total_steps)
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        if accum == 1:
            loss, metrics = api.loss(params, batch)
            loss.backward()
            grads = None   # the parameters' .grad
        else:
            # Gradient accumulation over microbatches: bounds the backward
            # transients. Accumulate in the param dtype scaled by 1/accum.
            loss, grads = accumulate_grads(api, params, batch, accum)
            metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                       device=api.device)}
        params, opt_state, om = oupdate(ocfg, grads, opt_state, params)
        params.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return train_step, oinit


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _arg_device(mesh) -> torch.device:
    """Where a cell's arguments live: fake tensors on the mesh's device type
    under an active ``FakeTensorMode``, else ``meta``."""
    from torch._guards import detect_fake_mode

    return torch.device(mesh.device_type if detect_fake_mode() is not None else "meta")


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _batch_structs(cfg, cell: ShapeCell, device) -> dict:
    b, t = cell.global_batch, cell.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    batch = {"tokens": _empty((b, t), torch.int32, device)}
    if cfg.embeds_input and not cfg.is_encoder_decoder:
        batch["embeds"] = _empty((b, t, cfg.d_model), cdt, device)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = _empty((b, t, cfg.d_model), cdt, device)
    return batch


def abstract_params(cfg) -> dict:
    """The reference-layout parameter tree of ``cfg`` (stacked layer groups)
    as ``meta`` tensors: the shapes and dtypes of the reference's
    ``jax.eval_shape(api.init)``."""
    return reference_tree(model_module(cfg, device="meta"))


def _meta_caches(cfg, batch: int, s_cache: int, t_enc: int):
    """The decode caches' structure on ``meta`` (``api.init_caches``'s)."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        return encdec.init_encdec_caches(cfg, batch, s_cache, t_enc, cdt, "meta")
    return transformer.init_decode_caches(cfg, batch, s_cache + cfg.meta_tokens, cdt, "meta")


def _tree_to(tree, device):
    """A tree of ``meta`` tensors as empty tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return _empty(tree.shape, tree.dtype, device)


def build_cell(cfg, cell: ShapeCell, mesh) -> CellProgram:
    dev = _arg_device(mesh)
    api = build_model(cfg, device=mesh.device_type)
    params_s = abstract_params(cfg)
    pspecs = shd.param_specs(cfg, params_s)
    p_shard = shd.named(mesh, pspecs)
    model = model_module(cfg, device=dev)
    div = shd.batch_size_divisor(mesh)
    name = f"{cfg.name}×{cell.name}"

    def batch_shardings(batch_s, split: bool):
        specs = shd.batch_specs(cfg, mesh, seq_shard=cfg.attn_layout != "heads_tp")
        return shd.named(mesh, {k: P(None, *specs[k]) if split else specs[k]
                                for k in batch_s})

    if cell.kind == "train":
        step, oinit = make_train_step(cfg, device=mesh.device_type)
        opt_s = oinit(model)
        ospecs = shd.optimizer_state_specs(pspecs, opt_s)
        accum = max(cfg.grad_accum, 1)
        batch_s = _batch_structs(cfg, cell, dev)
        if accum > 1:
            batch_s = split_batch(batch_s, accum)
        metrics_shard = {k: NamedSharding(mesh, P())
                         for k in ("loss", "nll", "aux", "grad_norm", "lr")}
        return CellProgram(
            name=name,
            fn=step,
            args=(model, opt_s, batch_s),
            in_shardings=(p_shard, shd.named(mesh, ospecs), batch_shardings(batch_s, accum > 1)),
            out_shardings=(p_shard, shd.named(mesh, ospecs), metrics_shard),
            donate_argnums=(0, 1),
            rules=_cell_rules(cfg, mesh),
        )

    if cell.kind == "prefill":
        batch_s = _batch_structs(cfg, cell, dev)

        def prefill_step(params, batch):
            return api.prefill(params, batch, s_cache=cell.seq_len)

        caches_s = _meta_caches(cfg, cell.global_batch, cell.seq_len, cell.seq_len)
        c_spec = shd.cache_specs(cfg, mesh, caches_s, batch_sharded=True)
        out_shard = (
            NamedSharding(mesh, shd.logits_spec(cfg, mesh)),
            shd.named(mesh, c_spec),
        )
        return CellProgram(
            name=name,
            fn=prefill_step,
            args=(model, batch_s),
            in_shardings=(p_shard, batch_shardings(batch_s, False)),
            out_shardings=out_shard,
            rules=_cell_rules(cfg, mesh),
        )

    # decode cells
    b = cell.global_batch
    batch_sharded = (b % div == 0) and b >= div
    rules = _cell_rules(cfg, mesh)
    if not batch_sharded:   # long_500k: batch=1 stays replicated
        rules["batch"] = None
    caches_s = _tree_to(_meta_caches(cfg, b, cell.seq_len, DECODE_T_ENC), dev)
    c_spec = shd.cache_specs(cfg, mesh, caches_s, batch_sharded=batch_sharded)
    c_shard = shd.named(mesh, c_spec)
    tok_spec, pos_spec = shd.decode_token_specs(cfg, mesh, batch_sharded)

    def serve_step(params, caches, token, pos):
        return api.decode_step(params, caches, token, pos)

    out_shard = (
        NamedSharding(mesh, shd.logits_spec(cfg, mesh, batch_sharded)),
        c_shard,
    )
    return CellProgram(
        name=name,
        fn=serve_step,
        args=(model, caches_s, _empty((b, 1), torch.int32, dev), _empty((b,), torch.int32, dev)),
        in_shardings=(p_shard, c_shard, NamedSharding(mesh, tok_spec),
                      NamedSharding(mesh, pos_spec)),
        out_shardings=out_shard,
        donate_argnums=(1,),
        rules=rules,
    )


# ---------------------------------------------------------------------------
# Placing and running a program
# ---------------------------------------------------------------------------


def _local_shape(shape, sharding: NamedSharding) -> tuple:
    sharding.check(shape)
    return tuple(n // shd.axis_size(sharding.mesh, sharding.spec[d]) if d < len(sharding.spec)
                 else n for d, n in enumerate(shape))


def _fake_shard(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """The rank's shard of ``x`` as a new tensor on the mesh's device (fake
    under the active mode): only its shape and dtype are read."""
    local = _empty(_local_shape(x.shape, sharding), x.dtype, sharding.mesh.device_type)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False)


def _real_shard(x, sharding: NamedSharding) -> DTensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return shd.distribute(t.detach().to(sharding.mesh.device_type), sharding)


def _place_module(model: nn.Module, shardings: dict, place) -> nn.Module:
    """A module like ``model`` whose parameters are DTensors placed by the
    reference-layout ``shardings`` (a stacked leaf's spec without its
    stacked dim for each layer)."""
    out = model_module(model.cfg, device="meta")
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = v
    walk(shardings)
    src = dict(model.named_parameters())
    for path, ps in reference_groups(out).items():
        s = flat[path]
        s = NamedSharding(s.mesh, P(*s.spec[1:])) if is_stacked(path) else s
        for name, p in ps:
            owner, _, leaf = name.rpartition(".")
            out.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                place(src[name], s), requires_grad=p.requires_grad)
    return out


def _place(value, sharding, place):
    if isinstance(value, nn.Module):
        return _place_module(value, sharding, place)
    if isinstance(value, dict):
        return {k: _place(v, sharding[k], place) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_place(v, s, place) for v, s in zip(value, sharding, strict=True))
    return place(value, sharding)


def place_args(prog: CellProgram, values: tuple | None = None) -> tuple:
    """The program's arguments placed by ``in_shardings``: ``values`` (global
    tensors or arrays, the same on every rank, and a parameter module) each
    rank keeping its slice; without ``values``, the rank's shards of
    ``prog.args`` as new empty tensors (fake under the active mode)."""
    place = _fake_shard if values is None else _real_shard
    return tuple(_place(v, s, place)
                 for v, s in zip(prog.args if values is None else values, prog.in_shardings,
                                 strict=True))


def _to_shardings(out, shardings):
    """The program's outputs redistributed to ``out_shardings`` (a module,
    updated in place, stays as it is)."""
    if isinstance(out, nn.Module):
        return out
    if isinstance(out, dict):
        return {k: _to_shardings(v, shardings[k]) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_shardings(v, s) for v, s in zip(out, shardings, strict=True))
    if isinstance(out, DTensor) and tuple(out.placements) != shardings.placements:
        return out.redistribute(shardings.mesh, shardings.placements)
    return out


def run_program(prog: CellProgram, mesh, args: tuple):
    """Run ``prog`` on placed ``args`` under its rules and implicit
    replication; its outputs come out placed by ``out_shardings``."""
    rules = prog.rules if prog.rules is not None else default_rules(mesh)
    with logical_axis_rules(mesh, rules), implicit_replication():
        return _to_shardings(prog.fn(*args), prog.out_shardings)


def lower_cell(prog: CellProgram, mesh):
    """Run ``prog`` once on the rank's fake shards under ``launch.cost``'s
    mode: the rank's flops, bytes, collective bytes and memory
    (:class:`~repro_torch.launch.cost.CostRecord`). Nothing is allocated."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.cost import measure

    with contextlib.nullcontext() if detect_fake_mode() is not None else FakeTensorMode():
        args = place_args(prog)
        _, rec = measure(lambda *a: run_program(prog, mesh, a), *args)
    return rec
