"""repro_torch.models.ssm against repro.models.ssm on the CPU.

Seeded numpy inputs and the reference's ``init_mamba`` parameters, float32,
rtol 1e-5 / atol 1e-5 per op (the SSD einsums and the chunk loop sum in
another order than XLA's; 2e-5 where a test says so). Covers ``_segsum``,
``ssd_chunked`` (with an initial state), ``ssd_reference``,
``ssd_decode_step``, the causal conv, the mamba block (sequence lengths
that pad to the chunk, and its final state) and decode continuing a prefill.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as js  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from test_torch_lm_layers import close, configs, fill  # noqa: E402

TOL = 2e-5


def _ssd_inputs(rng, b=2, t=24, h=3, p=4, n=5):
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def test_segsum_equal_reference():
    a = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    got, want = ts._segsum(torch.from_numpy(a)), np.asarray(js._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy() == ts.NEG_INF, want == js.NEG_INF)
    lower = want != js.NEG_INF
    close(got.numpy()[lower], want[lower])


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_equal_reference(chunk, with_state):
    rng = np.random.default_rng(1)
    x, dt, a, bm, cm = _ssd_inputs(rng)
    s0 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32) if with_state else None
    y, st = ts.ssd_chunked(*_t(x, dt, a, bm, cm), chunk=chunk,
                           initial_state=None if s0 is None else torch.from_numpy(s0))
    jy, jst = js.ssd_chunked(*_j(x, dt, a, bm, cm), chunk=chunk,
                             initial_state=None if s0 is None else jnp.asarray(s0))
    close(y, jy, TOL, TOL)
    close(st, jst, TOL, TOL)
    # ...and the naive recurrence (the tests' oracle) on both sides.
    ry, rst = ts.ssd_reference(*_t(x, dt, a, bm, cm),
                               initial_state=None if s0 is None else torch.from_numpy(s0))
    jry, jrst = js.ssd_reference(*_j(x, dt, a, bm, cm),
                                 initial_state=None if s0 is None else jnp.asarray(s0))
    close(ry, jry, TOL, TOL)
    close(rst, jrst, TOL, TOL)
    close(y, ry, 1e-4, 1e-4)


def test_ssd_chunked_rejects_ragged_length():
    x, dt, a, bm, cm = _ssd_inputs(np.random.default_rng(2), t=10)
    with pytest.raises(ValueError):
        ts.ssd_chunked(*_t(x, dt, a, bm, cm), chunk=4)


def test_ssd_decode_step_equal_reference():
    rng = np.random.default_rng(3)
    st = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    x1 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    dt1 = rng.uniform(0.01, 0.5, (2, 3)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (3,)).astype(np.float32)
    b1, c1 = rng.normal(size=(2, 2, 5)).astype(np.float32)
    y, ns = ts.ssd_decode_step(*_t(st, x1, dt1, a, b1, c1))
    jy, jns = js.ssd_decode_step(*_j(st, x1, dt1, a, b1, c1))
    close(y, jy)
    close(ns, jns)


def test_causal_conv_equal_reference():
    rng = np.random.default_rng(4)
    xbc = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    close(ts._causal_conv(*_t(xbc, w, b)), js._causal_conv(*_j(xbc, w, b)))


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
@pytest.mark.parametrize("t", [16, 13, 5])
def test_mamba_block_equal_reference(arch, t):
    """t = 16 is two chunks of 8, 13 pads the last chunk, 5 < chunk."""
    jcfg, cfg = configs(arch)
    p = jax.tree.map(np.asarray, js.init_mamba(jcfg, jax.random.key(5)))
    mod = fill(ts.Mamba(cfg), p)
    u = np.random.default_rng(5).normal(size=(2, t, cfg.d_model)).astype(np.float32)
    y, st = ts.apply_mamba(cfg, mod, torch.from_numpy(u), return_state=True)
    jy, jst = js.apply_mamba(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(u),
                             return_state=True)
    close(y, jy, TOL, TOL)
    close(st, jst, TOL, TOL)


def test_mamba_decode_continues_prefill_like_reference():
    """Three one-token decode steps from a zero cache, both sides."""
    jcfg, cfg = configs("mamba2-130m")
    p = jax.tree.map(np.asarray, js.init_mamba(jcfg, jax.random.key(6)))
    mod = fill(ts.Mamba(cfg), p)
    jp = jax.tree.map(jnp.asarray, p)
    cache = ts.init_mamba_cache(cfg, 2, torch.float32)
    jcache = js.init_mamba_cache(jcfg, 2, jnp.float32)
    rng = np.random.default_rng(6)
    for _ in range(3):
        u1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y, cache = ts.apply_mamba_decode(cfg, mod, torch.from_numpy(u1), cache)
        jy, jcache = js.apply_mamba_decode(jcfg, jp, jnp.asarray(u1), jcache)
        close(y, jy, TOL, TOL)
        close(cache["ssd"], jcache["ssd"], TOL, TOL)
        close(cache["conv"], jcache["conv"])


def test_mamba_init_deterministic_parameters_equal_reference():
    """A_log, D, dt_bias, gate_norm and conv_b are set where the block is
    built, equal to the reference's init (the random ones differ by design)."""
    jcfg, cfg = configs("mamba2-130m")
    p = js.init_mamba(jcfg, jax.random.key(0))
    mod = ts.Mamba(cfg)
    for k in ("A_log", "D", "dt_bias", "gate_norm", "conv_b"):
        close(getattr(mod, k).detach(), p[k], 1e-6, 1e-7)
