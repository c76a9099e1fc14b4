"""Gradients of the port's ``api.loss`` against ``jax.grad`` of the
reference's, every arch reduced, on the CPU.

Each arch's reference parameters (``api.init(jax.random.key(0))``) are
carried across by ``load_reference_params``; the same seeded batch (B = 2,
T = 16) goes through both, float32. The reference's stacked gradients come
across through ``params_from_reference``. Tolerances: the loss within
1e-6 relative; each parameter's gradient within max |Δ| ≤ 1e-5 · max |g|
of that parameter plus 1e-6 · max |g| of the whole model (a floor for
leaves whose gradients are near zero, e.g. whisper's self-attention keys).
The MoE inputs are checked for router ties, as the forward tests do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from test_torch_lm_models import _j, make_batch, pair  # noqa: E402

LOSS_RTOL, LEAF_RTOL, MODEL_RTOL = 1e-6, 1e-5, 1e-6


def assert_no_router_ties(cfg, api, model, batch, monkeypatch):
    """Run the forward with every router's probabilities recorded and check
    that no token's top-k choice sits on a tie (parity would be
    ill-posed: ``torch.topk`` and ``jax.lax.top_k`` break ties differently)."""
    from repro_torch.models import moe

    route = moe.route
    probs = []

    def recording(cfg_, p, x):
        probs.append(torch.softmax(torch.einsum("btd,de->bte", x.float(), p.router), -1))
        return route(cfg_, p, x)

    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad():
        api.forward(model, batch)
    monkeypatch.setattr(moe, "route", route)
    assert probs
    k = cfg.num_experts_per_tok
    for pr in probs:
        top = torch.sort(pr, dim=-1, descending=True).values[..., : k + 1]
        assert bool((torch.diff(top, dim=-1) < -1e-6).all()), "router ties"


def port_grads(api, model, batch) -> tuple[torch.Tensor, dict]:
    model.zero_grad(set_to_none=True)
    loss, _ = api.loss(model, batch)
    loss.backward()
    return loss.detach(), {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                           for n, p in model.named_parameters()}


def reference_grads(japi, params, batch, cfg):
    (loss, _), g = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(params, _j(batch))
    return float(loss), params_from_reference(cfg, jax.tree.map(np.asarray, g))


def assert_grads_close(got: dict, want: dict):
    top = max(float(w.abs().max()) for w in want.values())
    assert top > 0
    for name, w in want.items():
        d = float((got[name] - w).abs().max())
        bound = LEAF_RTOL * float(w.abs().max()) + MODEL_RTOL * top
        assert d <= bound, f"{name}: max |Δ| {d} > {bound}"


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_reference(arch, monkeypatch):
    jcfg, japi, params, cfg, api, model = pair(arch)
    batch = make_batch(cfg, np.random.default_rng(0), b=2, t=16)
    if cfg.num_experts:
        assert_no_router_ties(cfg, api, model, batch, monkeypatch)
    loss, got = port_grads(api, model, batch)
    jloss, want = reference_grads(japi, params, batch, cfg)
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert set(got) == set(want)
    assert_grads_close(got, want)
