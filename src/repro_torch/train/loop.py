"""The training loop: grad accumulation, checkpoint/restart, straggler
watchdog, graceful preemption. The port's counterpart of
``repro.train.loop``, on one process or sharded on a device mesh.

``train`` runs on ``device`` (default: the card; ``"cpu"`` for the CPU). It
initializes the model from ``torch.Generator(device).manual_seed(loop.seed)``
and feeds ``data.tokens.SyntheticTokens``. With ``loop.ckpt_dir`` it resumes
from the latest committed step + 1 and writes through ``AsyncCheckpointer``
every ``ckpt_every`` steps, and on preemption (SIGTERM/SIGINT) checkpoints
synchronously and stops. Checkpoints hold ``{"params", "opt"}`` in the
reference's layout (``models.convert.reference_tree``: stacked layer
groups), so either package can read the other's.

**On a mesh** (``train(cfg, loop, mesh=mesh)``, a ``DeviceMesh`` with dims
named as the reference's, e.g. ("data", "model")) the loop is the
reference's ``build_cell`` train program: the parameters are DTensors placed
by ``sharding.partition.param_specs``, the optimizer state by
``optimizer_state_specs`` over the reference's leaf view, each step's
global ``SyntheticTokens`` batch by ``batch_specs(seq_shard=attn_layout !=
"heads_tp")`` (each rank keeps its own slice), and the step runs under
``logical_axis_rules(mesh, _cell_rules(cfg, mesh))`` and
``implicit_replication()`` (see ``sharding.logical``); the metrics are
replicated (``full_tensor()``). A resume restores by ``restore(shardings=)``
onto this mesh, whatever mesh wrote the checkpoint. It is multi-controller,
as ``core.distributed``: every rank of the mesh calls ``train`` with the
same arguments, and ``params`` comes back with DTensor parameters whose
``full_tensor()`` is the global value. ``device`` must be of the mesh's
device type. With ``grad_accum > 1`` each global batch is split into its
microbatches before it is placed (``launch.steps.split_batch``: microbatch
``i`` is rows ``[i·B/accum, (i+1)·B/accum)``, as in the reference), each
microbatch by the batch specs, so every microbatch is spread over all the
batch shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch.steps import _cell_rules, make_train_step, micro_grads, split_batch
from repro_torch.models import build_model
from repro_torch.models.convert import flatten_paths, load_reference_tree, reference_tree
from repro_torch.models.model import model_module
from repro_torch.sharding.logical import logical_axis_rules
from repro_torch.sharding.partition import (
    NamedSharding,
    P,
    batch_specs,
    distribute,
    named,
    optimizer_state_specs,
    param_specs,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import GracefulShutdown, StepWatchdog, reshard_tree
from repro_torch.train.optimizer import make_optimizer

__all__ = ["TrainLoopConfig", "make_accum_train_step", "on_mesh", "shard_batch",
           "shard_params", "state_shardings", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: str | None = None
    grad_accum: int = 1
    seed: int = 0
    seq_len: int = 64
    global_batch: int = 16


def make_accum_train_step(cfg, accum: int, total_steps: int = 100_000, *, device=None):
    """Gradient accumulation: ``accum`` microbatches whose gradients are
    summed in float32, then divided by ``accum``, and one optimizer update
    (the same API as ``make_train_step``; the batch's leading dim must be
    accum x microbatch, or the batch comes split: ``launch.steps.split_batch``).
    Metrics: ``loss``, ``grad_norm``, ``lr``."""
    api = build_model(cfg, device=device)
    ocfg, oinit, oupdate = make_optimizer(cfg.optimizer, total_steps=total_steps)

    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.named_parameters()}
        lsum = torch.zeros((), dtype=torch.float32, device=api.device)
        for loss, gs in micro_grads(api, params, batch, accum):
            for k, g in gs.items():
                gsum[k] = gsum[k] + g
            lsum = lsum + loss
        n = torch.tensor(accum, dtype=torch.float32, device=api.device)
        grads = {k: g / n for k, g in gsum.items()}
        params, opt_state, om = oupdate(ocfg, grads, opt_state, params)
        return params, opt_state, {"loss": lsum / n, **om}

    return train_step, oinit


def shard_params(cfg, model: nn.Module, mesh) -> nn.Module:
    """Replace ``model``'s parameters, in place, by DTensors placed by
    ``param_specs`` (each rank keeps its slice of the global value)."""
    specs = dict(flatten_paths(param_specs(cfg, model)))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sharding = NamedSharding(mesh, specs[name.replace(".", "/")])
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), sharding), requires_grad=p.requires_grad)
    return model


def state_shardings(cfg, oinit, mesh) -> dict:
    """``{"params", "opt"}`` shardings of the checkpointed state in the
    reference's layout (stacked leaves), as the reference's ``build_cell``
    places them; shapes come from a ``meta`` model, so nothing is allocated."""
    meta = model_module(cfg, device="meta")
    pspecs = param_specs(cfg, reference_tree(meta))
    return named(mesh, {"params": pspecs,
                        "opt": optimizer_state_specs(pspecs, oinit(meta))})


def shard_batch(cfg, batch: dict, mesh, device, accum: int = 1) -> dict:
    """A global batch (numpy or tensors, the same on every rank) placed by
    ``batch_specs``: this rank's slice of it on ``device``. With ``accum >
    1`` it is split first (``split_batch``) and each microbatch placed by
    the specs: leaves ``(accum, B/accum, ...)`` on ``P(None, *spec)``."""
    specs = batch_specs(cfg, mesh, seq_shard=cfg.attn_layout != "heads_tp")
    batch = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
             for k, v in batch.items()}
    if accum > 1:
        batch = split_batch(batch, accum)
        specs = {k: P(None, *spec) for k, spec in specs.items()}
    return {k: distribute(v.to(device), NamedSharding(mesh, specs[k]))
            for k, v in batch.items()}


@contextlib.contextmanager
def on_mesh(cfg, mesh):
    """The context a sharded step runs in: the cell's logical-axis rules
    and implicit replication of the plain tensors the model builds."""
    with logical_axis_rules(mesh, _cell_rules(cfg, mesh)), implicit_replication():
        yield


def _replicated(v) -> float:
    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def train(cfg, loop: TrainLoopConfig, *, mesh=None,
          log_fn: Callable[[int, dict], None] | None = None, device=None) -> dict:
    """Run the loop; returns ``{"history", "params", "opt", "stragglers"}``
    (``params`` the model, updated in place). ``device=None`` is the card.
    ``mesh``: a ``DeviceMesh`` to shard over (see the module docstring)."""
    api = build_model(cfg, device=device)
    dev = api.device
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for parameters on {dev}")

    # LR schedule scaled to THIS run's length (warmup = ~total/10).
    if loop.grad_accum > 1:
        step_fn, oinit = make_accum_train_step(cfg, loop.grad_accum,
                                               total_steps=loop.total_steps, device=dev)
    else:
        step_fn, oinit = make_train_step(cfg, total_steps=loop.total_steps, device=dev)

    shardings = state_shardings(cfg, oinit, mesh) if mesh is not None else None
    start_step = 0
    model = opt = None
    if loop.ckpt_dir:
        last = ckpt.latest_step(loop.ckpt_dir)
        if last is not None:
            start_step, state = ckpt.restore(loop.ckpt_dir, last, shardings=shardings,
                                             device=dev)
            start_step += 1
            model = model_module(cfg, device=dev)
            if mesh is not None:
                shard_params(cfg, model, mesh)
            model = load_reference_tree(model, state["params"])
            opt = state["opt"]
            print(f"[train] resumed from step {last}")
    if model is None:
        model = api.init(torch.Generator(dev).manual_seed(loop.seed))
        if mesh is not None:
            shard_params(cfg, model, mesh)
        opt = oinit(model)
        if mesh is not None:
            opt = reshard_tree(opt, shardings["opt"])

    ds = SyntheticTokens(cfg.vocab_size, seq_len=loop.seq_len,
                         global_batch=loop.global_batch, seed=loop.seed)
    watchdog = StepWatchdog()
    shutdown = GracefulShutdown().install()
    writer = ckpt.AsyncCheckpointer(loop.ckpt_dir) if loop.ckpt_dir else None

    history = []
    try:
        for step in range(start_step, loop.total_steps):
            batch = ds.batch_at(step)
            watchdog.start()
            if mesh is None:
                model, opt, metrics = step_fn(model, opt, batch)
            else:
                with on_mesh(cfg, mesh):
                    model, opt, metrics = step_fn(model, opt, shard_batch(
                        cfg, batch, mesh, dev, accum=loop.grad_accum))
            metrics = {k: _replicated(v) for k, v in metrics.items()}   # waits for the step
            dt = watchdog.stop(step)
            metrics["step_time_s"] = dt
            if step % loop.log_every == 0 or step == loop.total_steps - 1:
                history.append({"step": step, **metrics})
                if log_fn:
                    log_fn(step, metrics)
                else:
                    print(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                          f"({dt*1e3:.0f}ms)")
            if writer and (step % loop.ckpt_every == 0 and step > 0):
                writer.save(step, {"params": reference_tree(model), "opt": opt})
            if shutdown.requested:
                print(f"[train] preemption at step {step}: checkpointing + exit")
                if loop.ckpt_dir:
                    ckpt.save(loop.ckpt_dir, step, {"params": reference_tree(model),
                                                    "opt": opt})
                break
        if writer:
            writer.wait()
    finally:
        shutdown.uninstall()
    return {"history": history, "params": model, "opt": opt,
            "stragglers": watchdog.stragglers}
