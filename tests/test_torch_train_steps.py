"""Train steps of the port against the reference's, on the CPU.

Three steps from the same parameters on the same ``SyntheticTokens``
batches (B = 2, T = 32): ``launch.steps.make_train_step`` on smollm-135m
reduced (AdamW) and mixtral-8x7b reduced (Adafactor), and gradient
accumulation over two microbatches through both ``make_train_step``
(``cfg.grad_accum = 2``: the param-dtype sum of g / accum) and
``train.loop.make_accum_train_step`` (a float32 sum, then / accum). After
each step the metrics (``loss``, ``grad_norm``, ``lr``, and ``nll`` /
``aux`` where the step reports them) agree; after the last, every
parameter and the optimizer state. Tolerance rtol 1e-5 / atol 1e-6: three
steps of float32 forward, backward and update, summed in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.tokens import SyntheticTokens as JTokens  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.train.loop import make_accum_train_step as jmake_accum  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.loop import make_accum_train_step  # noqa: E402
from test_torch_lm_models import pair  # noqa: E402
from test_torch_train_optimizer import assert_state_close  # noqa: E402

RTOL, ATOL, TOTAL = 1e-5, 1e-6, 20


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


CASES = {
    "smollm-adamw": ("smollm-135m", 1, "steps"),
    "mixtral-adafactor": ("mixtral-8x7b", 1, "steps"),
    "smollm-accum2-steps": ("smollm-135m", 2, "steps"),
    "smollm-accum2-loop": ("smollm-135m", 2, "loop"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_equal_reference(case):
    arch, accum, make = CASES[case]
    over = {"grad_accum": accum} if make == "steps" and accum > 1 else {}
    jcfg, _, params, cfg, _, model = pair(arch, **over)
    if make == "steps":
        jstep, jinit = jmake_train_step(jcfg, total_steps=TOTAL)
        step, init = make_train_step(cfg, total_steps=TOTAL, device="cpu")
    else:
        jstep, jinit = jmake_accum(jcfg, accum, total_steps=TOTAL)
        step, init = make_accum_train_step(cfg, accum, total_steps=TOTAL, device="cpu")
    jstate, state = jinit(params), init(model)
    jds = JTokens(cfg.vocab_size, seq_len=32, global_batch=2, seed=5)
    ds = SyntheticTokens(cfg.vocab_size, seq_len=32, global_batch=2, seed=5)
    jstep = jax.jit(jstep)
    for k in range(3):
        batch = ds.batch_at(k)
        np.testing.assert_array_equal(batch["tokens"], jds.batch_at(k)["tokens"])
        params, jstate, jm = jstep(params, jstate, jax.tree.map(jnp.asarray, batch))
        model, state, m = step(model, state, batch)
        assert set(m) == set(jm), (sorted(m), sorted(jm))
        for key in jm:
            close(m[key], jm[key], f"step {k} {key}")
        assert all(p.grad is None for p in model.parameters())   # freed
    want = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    for n, p in model.named_parameters():
        close(p, want[n], n)
    assert_state_close(state, jax.tree.map(np.asarray, jstate))
    assert int(state["step"]) == 3
