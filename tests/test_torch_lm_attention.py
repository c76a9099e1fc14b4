"""repro_torch.models.attention against repro.models.attention on the CPU.

Seeded numpy inputs, float32, rtol 1e-5 / atol 1e-5; the bfloat16 case at
rtol / atol 2e-2 (bfloat16 scores and weights, float32 softmax state).
Covers ``sdpa_direct`` and ``sdpa_chunked`` (causal, sliding window,
invalid ``k_pos`` slots, T not a multiple of the chunk, GQA groups, cross
attention with S != T) and the projections with the reference's own
parameters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from test_torch_lm_layers import close, configs, fill  # noqa: E402


def _qkv(rng, b=2, t=11, s=11, h=6, kv=2, d=8):
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v


def _both(fn_t, fn_j, arrays, ints, **kw):
    got = fn_t(*[torch.from_numpy(a) for a in arrays + ints], **kw)
    want = fn_j(*[jnp.asarray(a) for a in arrays + ints], **kw)
    return got, want


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 0, 3])
def test_sdpa_direct_equal_reference(causal, window):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    kpos = pos.copy()
    kpos[0, 7:] = -1      # unwritten cache slots
    got, want = _both(ta.sdpa_direct, ja.sdpa_direct, [q, k, v], [pos, kpos],
                      causal=causal, window=window)
    close(got, want)


@pytest.mark.parametrize("t,chunk", [(37, 8), (32, 8), (20, 16), (9, 16)])
@pytest.mark.parametrize("window", [None, 5])
def test_sdpa_chunked_equal_reference(t, chunk, window):
    """Padded last chunk (37 / 8, 20 / 16), exact chunks, and the direct
    fallback (S <= chunk)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, t=t, s=t)
    pos = np.tile(np.arange(t, dtype=np.int32), (2, 1))
    kpos = pos.copy()
    kpos[1, : t // 3] = -1  # invalid slots inside the chunks
    got, want = _both(ta.sdpa_chunked, ja.sdpa_chunked, [q, k, v], [pos, kpos],
                      causal=True, window=window, chunk=chunk)
    close(got, want)


def test_sdpa_chunked_cross_attention_shape():
    """Non-causal, S != T (encoder memory longer than the decoder)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, t=5, s=23, h=4, kv=4)
    qpos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    mpos = np.tile(np.arange(23, dtype=np.int32), (2, 1))
    got, want = _both(ta.sdpa_chunked, ja.sdpa_chunked, [q, k, v], [qpos, mpos],
                      causal=False, chunk=8)
    close(got, want)


def test_sdpa_chunked_bf16_cast_points():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, t=40, s=40)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    got = ta.sdpa_chunked(*[torch.from_numpy(a).bfloat16() for a in (q, k, v)],
                          torch.from_numpy(pos), torch.from_numpy(pos), chunk=16)
    want = ja.sdpa_chunked(*[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)],
                           jnp.asarray(pos), jnp.asarray(pos), chunk=16)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), 2e-2, 2e-2)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium"])
def test_self_and_cross_attention_equal_reference(arch):
    """Projections (rope for smollm, none for whisper), GQA grouping and the
    output projection, with the reference's init_attention parameters."""
    jcfg, cfg = configs(arch)
    p = jax.tree.map(np.asarray, ja.init_attention(jcfg, jax.random.key(4)))
    mod = fill(ta.Attention(cfg), p)
    assert tuple(mod.wq.shape) == (cfg.d_model, cfg.num_heads, cfg.head_dim_)
    assert tuple(mod.wo.shape) == (cfg.num_heads, cfg.head_dim_, cfg.d_model)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 17, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(13, dtype=np.int32), (2, 1))
    mpos = np.tile(np.arange(17, dtype=np.int32), (2, 1))
    jp = jax.tree.map(jnp.asarray, p)
    close(ta.self_attention(cfg, mod, torch.from_numpy(x), torch.from_numpy(pos), window=4,
                            chunk=8),
          ja.self_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), window=4, chunk=8))
    close(ta.cross_attention(cfg, mod, torch.from_numpy(x), torch.from_numpy(mem),
                             torch.from_numpy(pos), torch.from_numpy(mpos), chunk=8),
          ja.cross_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(pos),
                             jnp.asarray(mpos), chunk=8))


def test_mask_equal_reference():
    rng = np.random.default_rng(5)
    qp = rng.integers(0, 20, (2, 6)).astype(np.int32)
    kp = rng.integers(-1, 20, (2, 9)).astype(np.int32)
    for causal in (True, False):
        for window in (None, 0, 4):
            got = ta._mask(torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
                           window=window)
            want = ja._mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal, window=window)
            # Either side may keep a broadcastable (B, 1, S) mask.
            np.testing.assert_array_equal(np.broadcast_to(got.numpy(), (2, 6, 9)),
                                          np.broadcast_to(np.asarray(want), (2, 6, 9)))
