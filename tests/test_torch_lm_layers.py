"""repro_torch.models.layers against repro.models.layers on the CPU.

The same numpy inputs (seeded) and the reference's own parameters
(``init_*`` from ``jax.random.key``) go through both packages, float32,
rtol 1e-5 / atol 1e-5 unless a test says otherwise. The bfloat16 tests hold
the port's cast points to the reference's at bfloat16's resolution
(rtol 1e-2 / atol 1e-2: one rounding of a value near 1 is 2^-8).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

RTOL = ATOL = 1e-5
BF16_TOL = 1e-2


def leaves(tree, prefix=""):
    """("a/b", numpy leaf) pairs of a reference parameter dict."""
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, p)
        else:
            yield p, np.array(v)


def fill(module, tree):
    """Load a reference parameter dict into a port module (same paths)."""
    module.load_state_dict({p.replace("/", "."): torch.from_numpy(v)
                            for p, v in leaves(tree)}, strict=True)
    return module


def configs(arch, **over):
    """The reference's and the port's reduced config of ``arch``."""
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def to_jax(x, dtype=None):
    a = jnp.asarray(x)
    return a.astype(dtype) if dtype is not None else a


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_nonparam"])
def test_norms_equal_reference(norm):
    jcfg, cfg = configs("smollm-135m", norm=norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32) * 3 + 1
    p = jax.tree.map(np.asarray, jl.init_norm(jcfg, jax.random.key(0)))
    if p:  # non-trivial affine parameters
        p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    mod = fill(tl.Norm(cfg), p)
    close(tl.apply_norm(cfg, mod, torch.from_numpy(x)),
          jl.apply_norm(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_bf16_cast_points(norm):
    jcfg, cfg = configs("smollm-135m", norm=norm)
    x = np.random.default_rng(1).normal(size=(3, 64)).astype(np.float32)
    p = jax.tree.map(np.asarray, jl.init_norm(jcfg, jax.random.key(0)))
    got = tl.apply_norm(cfg, fill(tl.Norm(cfg), p), torch.from_numpy(x).bfloat16())
    want = jl.apply_norm(jcfg, jax.tree.map(jnp.asarray, p), to_jax(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium"])
def test_mlp_equal_reference(arch):
    """SwiGLU (llama family) and GELU (whisper: the tanh approximation)."""
    jcfg, cfg = configs(arch)
    x = np.random.default_rng(2).normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    p = jax.tree.map(np.asarray, jl.init_mlp(jcfg, jax.random.key(3)))
    mod = fill(tl.MLP(cfg), p)
    want = jl.apply_mlp(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(tl.apply_mlp(cfg, mod, torch.from_numpy(x)), want)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; F.gelu's default (erf) would differ by
    more than the parity tolerance on these inputs."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    close(torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh"), want)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_equal_reference(theta, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    got = tl.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), theta)
    want = jl.apply_rope(to_jax(x, jdt), jnp.asarray(pos), theta)
    assert got.dtype == tdt
    tol = (1e-4, 1e-4) if dtype == "float32" else (BF16_TOL, BF16_TOL)
    close(got, np.asarray(want.astype(jnp.float32)), *tol)
    close(tl.rope_frequencies(16, theta), jl.rope_frequencies(16, theta), 1e-6, 0)


def test_sinusoidal_positions_equal_reference():
    """Frequencies within one float32 ulp (XLA's exp and torch's differ in the
    last bit); at positions near 3000 an angle's ulp is 2.4e-4, so sin/cos
    agree to atol 5e-4 there and to 1e-5 at small positions."""
    _, cfg = configs("whisper-medium")
    close(tl.sinusoidal_positions(torch.arange(8)[None], 64),
          jl.sinusoidal_positions(jnp.arange(8)[None], 64), 1e-5, 1e-5)
    pos = np.arange(0, 2996, 7, dtype=np.int32).reshape(2, -1)
    close(tl.sinusoidal_positions(torch.from_numpy(pos), 64),
          jl.sinusoidal_positions(jnp.asarray(pos), 64), 0, 5e-4)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_unembed_with_padded_vocab(tie):
    """vocab 200 pads to 256: padded logits are -1e9 on both sides."""
    jcfg, cfg = configs("smollm-135m", vocab_size=200, tie_embeddings=tie)
    assert cfg.padded_vocab == 256
    p = jax.tree.map(np.asarray, jl.init_embeddings(jcfg, jax.random.key(5)))
    mod = fill(tl.Embeddings(cfg), p)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 200, (2, 6)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    close(tl.embed_tokens(cfg, mod, torch.from_numpy(ids), torch.float32),
          jl.embed_tokens(jcfg, jp, jnp.asarray(ids), jnp.float32))
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    got = tl.unembed(cfg, mod, torch.from_numpy(x))
    want = jl.unembed(jcfg, jp, jnp.asarray(x))
    close(got, want)
    assert (got[..., 200:] == -1e9).all() and got.argmax(-1).max() < 200


def test_out_of_range_token_id_raises():
    """The reference's jnp.take clamps an id past the table; the port's
    indexing raises (ids stay < vocab_size by contract)."""
    _, cfg = configs("smollm-135m")
    mod = tl.Embeddings(cfg)
    with pytest.raises(IndexError):
        tl.embed_tokens(cfg, mod, torch.tensor([[cfg.padded_vocab]]), torch.float32)


def test_bf16_params_cast_to_compute_dtype():
    """bfloat16 parameters (llava, mixtral, arctic) and float32 compute: the
    MLP casts its weights to the input's dtype, as the reference does."""
    jcfg, cfg = configs("smollm-135m", param_dtype="bfloat16")
    p = jax.tree.map(np.asarray, jl.init_mlp(jcfg, jax.random.key(6)))
    mod = tl.MLP(cfg)
    assert mod.w_gate.dtype == torch.bfloat16
    mod.load_state_dict({k: torch.from_numpy(v.astype(np.float32)).bfloat16()
                         for k, v in p.items()})
    x = np.random.default_rng(6).normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    want = jl.apply_mlp(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(tl.apply_mlp(cfg, mod, torch.from_numpy(x)), want)


def test_config_dataclass_replace_keeps_parity():
    jcfg, cfg = configs("hymba-1.5b", d_model=32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
