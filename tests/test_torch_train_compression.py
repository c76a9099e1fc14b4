"""The port's int8 gradient compression with error feedback on the CPU: the
counterparts of the compression half of ``tests/test_compression_conflicts.py``
(round trip within half a scale, the telescoping invariant, a hypothesis
property), and the int8 values and scales bit for bit against the
reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")  # dev-only dep (requirements-dev.txt)
import hypothesis.extra.numpy as hnp  # noqa: E402
import hypothesis.strategies as st  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.train.compression import (  # noqa: E402
    compress,
    compress_grads,
    decompress,
    init_state,
)


def _tree(rng):
    return {"a": torch.as_tensor(rng.normal(size=(16, 8)), dtype=torch.float32) * 3,
            "b": torch.as_tensor(rng.normal(size=(5,)), dtype=torch.float32) * 0.01}


def test_compress_roundtrip_error_bounded(rng):
    t = _tree(rng)
    q, s = compress(t)
    back = decompress(q, s)
    for x, y, sc in zip(pytree.tree_leaves(t), pytree.tree_leaves(back), pytree.tree_leaves(s)):
        assert y.dtype == torch.float32
        # |error| <= scale/2 per element (symmetric int8 rounding)
        assert float((x - y).abs().max()) <= float(sc) * 0.5 + 1e-7
    assert all(x.dtype == torch.int8 for x in pytree.tree_leaves(q))


def test_error_feedback_telescopes():
    """Σ_k decompress(Q_k) + the last residual == Σ_k g_k, up to float32
    rounding: the invariant that makes compressed all-reduce unbiased."""
    grads = [_tree(np.random.default_rng(i)) for i in range(8)]
    res = init_state(grads[0])
    applied = pytree.tree_map(torch.zeros_like, grads[0])
    for g in grads:
        q, s, res = compress_grads(g, res)
        applied = pytree.tree_map(lambda a, d: a + d, applied, decompress(q, s))
    true_sum = pytree.tree_map(lambda *xs: sum(xs), *grads)
    for a, r, t in zip(pytree.tree_leaves(applied), pytree.tree_leaves(res),
                       pytree.tree_leaves(true_sum)):
        np.testing.assert_allclose((a + r).numpy(), t.numpy(), rtol=1e-4, atol=1e-4)


@hypothesis.given(
    g=hnp.arrays(np.float32, st.integers(1, 64), elements=st.floats(-100, 100, width=32)),
)
@hypothesis.settings(max_examples=25, deadline=None)
def test_compress_property(g):
    q, s = compress({"g": torch.from_numpy(g)})
    back = decompress(q, s)["g"].numpy()
    assert np.all(np.abs(back - g) <= float(s["g"]) * 0.5 + 1e-6)


def test_int8_values_and_scales_equal_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.train import compression as jcomp

    rng = np.random.default_rng(7)
    trees = [{"a": rng.normal(size=(64, 33)).astype(np.float32) * 3,
              "b": rng.normal(size=(257,)).astype(np.float32) * 1e-3,
              "c": np.zeros((4,), np.float32),
              "d": (rng.integers(-3, 4, size=(40,)) * 0.5).astype(np.float32)}  # ties
             for _ in range(3)]
    res = init_state({k: torch.from_numpy(v) for k, v in trees[0].items()})
    jres = jcomp.init_state(jax.tree.map(jnp.asarray, trees[0]))
    for tree in trees:
        q, s, res = compress_grads({k: torch.from_numpy(v) for k, v in tree.items()}, res)
        jq, js, jres = jcomp.compress_grads(jax.tree.map(jnp.asarray, tree), jres)
        for k in tree:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]), err_msg=k)
            assert s[k].numpy().tobytes() == np.asarray(js[k]).tobytes(), k
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]), err_msg=k)
