"""The training loop: grad accumulation, checkpoint/restart, straggler
watchdog, graceful preemption. The port's counterpart of
``repro.train.loop``, single-process: ``train(..., mesh=)`` waits for the
port's mesh slice (ROADMAP Queue 1 item B).

``train`` runs on ``device`` (default: the card; ``"cpu"`` for the CPU). It
initializes the model from ``torch.Generator(device).manual_seed(loop.seed)``
and feeds ``data.tokens.SyntheticTokens``. With ``loop.ckpt_dir`` it resumes
from the latest committed step + 1 and writes through ``AsyncCheckpointer``
every ``ckpt_every`` steps, and on preemption (SIGTERM/SIGINT) checkpoints
synchronously and stops. Checkpoints hold ``{"params", "opt"}`` in the
reference's layout (``models.convert.reference_tree``: stacked layer
groups), so either package can read the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch.steps import make_train_step, micro_grads
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_tree, reference_tree
from repro_torch.models.model import model_module
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import GracefulShutdown, StepWatchdog
from repro_torch.train.optimizer import make_optimizer

__all__ = ["TrainLoopConfig", "make_accum_train_step", "train"]


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
    accum x microbatch). Metrics: ``loss``, ``grad_norm``, ``lr``."""
    api = build_model(cfg, device=device)
    ocfg, oinit, oupdate = make_optimizer(cfg.optimizer, total_steps=total_steps)

    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=api.device)
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


def train(cfg, loop: TrainLoopConfig, *, mesh=None,
          log_fn: Callable[[int, dict], None] | None = None, device=None) -> dict:
    """Run the loop; returns ``{"history", "params", "opt", "stragglers"}``
    (``params`` the model, updated in place). ``device=None`` is the card."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) shards the model over a device mesh: the port's mesh "
            "slice (ROADMAP Queue 1 item B) is not ported yet")
    api = build_model(cfg, device=device)
    dev = api.device

    # LR schedule scaled to THIS run's length (warmup = ~total/10).
    if loop.grad_accum > 1:
        step_fn, oinit = make_accum_train_step(cfg, loop.grad_accum,
                                               total_steps=loop.total_steps, device=dev)
    else:
        step_fn, oinit = make_train_step(cfg, total_steps=loop.total_steps, device=dev)

    start_step = 0
    model = opt = None
    if loop.ckpt_dir:
        last = ckpt.latest_step(loop.ckpt_dir)
        if last is not None:
            start_step, state = ckpt.restore(loop.ckpt_dir, last, device=dev)
            start_step += 1
            model = load_reference_tree(model_module(cfg, device=dev), state["params"])
            opt = state["opt"]
            print(f"[train] resumed from step {last}")
    if model is None:
        model = api.init(torch.Generator(dev).manual_seed(loop.seed))
        opt = oinit(model)

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
            model, opt, metrics = step_fn(model, opt, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
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
