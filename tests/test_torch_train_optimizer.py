"""The port's AdamW and Adafactor against the reference's, on the CPU.

The same parameters (the reference's tree carried across by
``load_reference_params``) and the same seeded gradients go through one and
three updates of both packages. The port updates over the reference's leaf
view (stacked layer groups), so the rules that read the stacked leaf — decay
of rank >= 2 leaves, Adafactor's factoring and RMS clip — decide as the
reference does: smollm-135m reduced (AdamW), hymba-1.5b reduced (single-layer
groups, ``(1, d)`` norm scales: decayed, not factored), mixtral-8x7b reduced
(Adafactor), and Adafactor's layer-by-layer path (``_CHUNKED_UPDATE_BYTES``
set low in both modules, inside the test only). Float32 parameters within
rtol 1e-6 / atol 1e-7; the optimizer state, ``grad_norm`` and ``lr`` too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.train.optimizer as jopt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import load_reference_params, params_from_reference  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def setup(arch):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    params = jbuild(jcfg).init(jax.random.key(0))
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, model


def grads_at(params, k: int):
    """Seeded gradients shaped like the reference tree (numpy)."""
    rng = np.random.default_rng(100 + k)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.05).astype(np.float32), params)


def assert_state_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_state_close(got[k], want[k], f"{path}/{k}")
    else:
        assert tuple(got.shape) == tuple(np.shape(want)), path
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            assert int(got) == int(want), path
        else:
            close(got, want, path)


CASES = {
    "smollm-adamw": ("smollm-135m", "adamw", {}),
    "hymba-adamw": ("hymba-1.5b", "adamw", {}),
    "hymba-adafactor-decay": ("hymba-1.5b", "adafactor", {"weight_decay": 0.01}),
    "mixtral-adafactor": ("mixtral-8x7b", "adafactor", {}),
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_equals_reference(case, steps):
    arch, name, over = CASES[case]
    cfg, params, model = setup(arch)
    jocfg, jinit, jupdate = jopt.make_optimizer(name, total_steps=10)
    ocfg, oinit, oupdate = topt.make_optimizer(name, total_steps=10)
    jocfg, ocfg = dataclasses.replace(jocfg, **over), dataclasses.replace(ocfg, **over)
    jstate, state = jinit(params), oinit(model)
    if arch == "hymba-1.5b":
        # Single-layer groups: a (1, d) norm scale is decayed but not factored.
        st = (state["mu"] if name == "adamw" else state["v"])["group_0"]["ln1"]["scale"]
        assert (tuple(st.shape) == (1, cfg.d_model)) if name == "adamw" else set(st) == {"v"}
    jupd = jax.jit(lambda g, s, p: jupdate(jocfg, g, s, p))
    for k in range(steps):
        g = grads_at(params, k)
        params, jstate, jm = jupd(jax.tree.map(jnp.asarray, g), jstate, params)
        grads = params_from_reference(cfg, g)
        model, state, m = oupdate(ocfg, grads, state, model)
        close(m["grad_norm"], jm["grad_norm"], "grad_norm")
        close(m["lr"], jm["lr"], "lr")
    want = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    for n, p in model.named_parameters():
        close(p, want[n], n)
    assert_state_close(state, jax.tree.map(np.asarray, jstate))


def test_adafactor_layer_by_layer_equals_reference(monkeypatch):
    """Leaves over ``_CHUNKED_UPDATE_BYTES`` update one layer's slice at a
    time (factoring, RMS clip and decay per slice); the threshold is set low
    in both modules so mixtral's stacked expert weights take that path."""
    monkeypatch.setattr(jopt, "_CHUNKED_UPDATE_BYTES", 64 << 10)
    monkeypatch.setattr(topt, "_CHUNKED_UPDATE_BYTES", 64 << 10)
    cfg, params, model = setup("mixtral-8x7b")
    chunked = [p for p in jax.tree.leaves(params) if jopt._chunk_leading(p)]
    assert chunked, "no leaf takes the layer-by-layer path"
    ocfg = topt.AdafactorConfig(lr=0.01, weight_decay=0.01)
    jocfg = jopt.AdafactorConfig(lr=0.01, weight_decay=0.01)
    jstate, state = jopt.adafactor_init(params), topt.adafactor_init(model)
    for k in range(3):
        g = grads_at(params, k)
        params, jstate, _ = jopt.adafactor_update(jocfg, jax.tree.map(jnp.asarray, g),
                                                  jstate, params)
        model, state, _ = topt.adafactor_update(ocfg, params_from_reference(cfg, g),
                                                state, model)
    want = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    for n, p in model.named_parameters():
        close(p, want[n], n)
    assert_state_close(state, jax.tree.map(np.asarray, jstate))


def test_per_layer_rank_would_differ():
    """The trap the leaf view avoids: a stacked (C, d) norm scale is decayed
    (rank 2) where its per-layer (d,) tensors would not be."""
    cfg, params, model = setup("smollm-135m")
    before = model.group_0[0].ln1.scale.detach().clone()
    state = topt.adamw_init(model)
    zero = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    topt.adamw_update(topt.AdamWConfig(lr=0.1, weight_decay=0.5), zero, state, model)
    # Zero gradient: only the decay moves the parameter, by lr * wd * p.
    torch.testing.assert_close(model.group_0[0].ln1.scale, before * (1 - 0.1 * 0.5))
    np.testing.assert_array_equal(state["mu"]["group_0"]["ln1"]["scale"].shape,
                                  (cfg.num_layers, cfg.d_model))
