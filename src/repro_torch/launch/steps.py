"""Train-step factories; the port's counterpart of ``repro.launch.steps``, with
``make_train_step`` and the cells' logical-axis rules (``_cell_rules``) so
far (``build_cell``, ``lower_cell`` and ``abstract_params`` wait for ROADMAP
Queue 1 item C).

``train_step(params, opt_state, batch)`` differentiates ``api.loss`` with
``torch.autograd`` and updates the parameters and the optimizer state in
place under ``torch.no_grad`` (the port's counterpart of the reference's
``donate_argnums``); it frees the gradients (``set_to_none``) and returns
``(params, opt_state, metrics)`` with ``loss``, ``nll``, ``aux``,
``grad_norm`` and ``lr``. With ``cfg.grad_accum > 1`` the batch is split
into that many microbatches whose gradients are summed in the parameters'
dtype, each scaled by 1/accum, as the reference's scan does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.sharding.logical import default_rules
from repro_torch.train.optimizer import make_optimizer

__all__ = ["make_train_step", "micro_grads"]


def _cell_rules(cfg, mesh) -> dict:
    """The logical-axis rules of ``cfg`` on ``mesh``: ``default_rules``, with
    the heads_tp layout's flip (sequence unsharded, heads over "model")."""
    rules = default_rules(mesh)
    if cfg.attn_layout == "heads_tp":
        rules["seq"] = None
        rules["kv_seq"] = None
        rules["heads"] = "model"
    return rules


def micro_grads(api, params, batch: dict, accum: int):
    """Split the batch's leading axis into ``accum`` microbatches; for each,
    yield its loss (detached) and ``{name: gradient}`` (a parameter the loss
    does not reach is left out)."""
    parts = [dict() for _ in range(accum)]
    for k, v in batch.items():
        t = (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(api.device)
        for i, part in enumerate(t.reshape((accum, t.shape[0] // accum) + tuple(t.shape[1:]))):
            parts[i][k] = part
    named = list(params.named_parameters())
    for mb in parts:
        loss, _ = api.loss(params, mb)
        gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        yield loss.detach(), {k: g for (k, _), g in zip(named, gs) if g is not None}


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
            n = torch.tensor(accum, dtype=torch.float32, device=api.device)
            grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            for mloss, gs in micro_grads(api, params, batch, accum):
                for k, g in gs.items():
                    grads[k] = grads[k] + (g / n).to(grads[k].dtype)
                loss = loss + mloss / n
            metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                       device=api.device)}
        params, opt_state, om = oupdate(ocfg, grads, opt_state, params)
        params.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return train_step, oinit
