"""repro_torch.models.moe against repro.models.moe on the CPU.

The reference's ``init_moe`` parameters, seeded numpy tokens, float32,
rtol 1e-5 / atol 1e-5. Router probabilities of these inputs have no ties,
so ``torch.topk`` and ``jax.lax.top_k`` pick the same experts (their tie
orders differ). Both dispatch strategies run with and without capacity
drops; arctic's dense residual rides along.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jm  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from test_torch_lm_layers import close, configs, fill  # noqa: E402


def _setup(arch="mixtral-8x7b", seed=0, **over):
    jcfg, cfg = configs(arch, **over)
    p = jax.tree.map(np.asarray, jm.init_moe(jcfg, jax.random.key(seed)))
    x = np.random.default_rng(seed).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, p), fill(tm.MoE(cfg), p), x


def _no_ties(probs: np.ndarray, k: int):
    top = np.sort(probs, axis=-1)[..., ::-1][..., : k + 1]
    assert (np.diff(top, axis=-1) < -1e-6).all(), "router ties: parity would be ill-posed"


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_route_equal_reference(arch):
    jcfg, cfg, jp, mod, x = _setup(arch)
    ids, gates, aux, load = tm.route(cfg, mod, torch.from_numpy(x))
    jids, jgates, jaux, jload = jm.route(jcfg, jp, jnp.asarray(x))
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", jnp.asarray(x), jp["router"]), -1)
    _no_ties(np.asarray(probs), cfg.num_experts_per_tok)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(gates, jgates)
    close(aux, jaux)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_apply_moe_equal_reference(arch, dispatch, capacity_factor):
    """capacity_factor 8: nothing drops; 1.0 and 0.5: over-capacity votes
    drop (masked onto the in-bounds sentinel row in the gather path)."""
    jcfg, cfg, jp, mod, x = _setup(arch, moe_dispatch=dispatch,
                                   capacity_factor=capacity_factor)
    y, aux = tm.apply_moe(cfg, mod, torch.from_numpy(x))
    jy, jaux = jm.apply_moe(jcfg, jp, jnp.asarray(x))
    close(y, jy)
    close(aux, jaux)
    if capacity_factor < 1.0:   # drops happened: the dense oracle differs
        oracle = tm.moe_dense_oracle(cfg, mod, torch.from_numpy(x))
        assert (oracle - y).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_dense_oracle_equal_reference_and_dispatches(arch):
    jcfg, cfg, jp, mod, x = _setup(arch, capacity_factor=8.0)
    oracle = tm.moe_dense_oracle(cfg, mod, torch.from_numpy(x))
    close(oracle, jm.moe_dense_oracle(jcfg, jp, jnp.asarray(x)))
    for dispatch in ("einsum", "gather"):
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        close(tm.apply_moe(c, mod, torch.from_numpy(x))[0], oracle)


def test_arctic_dense_residual_present():
    _, cfg, _, mod, _ = _setup("arctic-480b")
    assert cfg.moe_dense_residual and hasattr(mod, "dense")
    assert tuple(mod.dense.w_gate.shape) == (cfg.d_model, cfg.dense_residual_ff)


def test_slot_positions_equal_reference():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 4, (3, 20))
    oh = np.eye(4, dtype=np.int32)[ids]
    got = tm._slot_positions(torch.from_numpy(oh))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jm._slot_positions(jnp.asarray(oh[b]))))
    assert got.dtype == torch.int32


def test_capacity_equal_reference():
    for arch in ("mixtral-8x7b", "arctic-480b"):
        for cf in (0.25, 1.25, 8.0):
            jcfg, cfg = configs(arch, capacity_factor=cf)
            for tokens in (1, 7, 64):
                assert tm._capacity(cfg, tokens) == jm._capacity(jcfg, tokens)
