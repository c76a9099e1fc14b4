"""f1–f13 of the Haralick features (``kernels.tail_kernel.haralick_tail``).

On the CPU: the wrapper's plain version against the PyTorch tail it stands
for (``core.haralick.haralick_features`` on the counts, and on the float32
P a plan with ``normalize`` makes), bit for bit, on random, smooth-band,
one-level-marginal, single-entry and all-zero counts; ``select``; symmetric
plans; the wrapper's argument checks; the plan's ``solver``; the analyzer's
launch rule; the benchmark's reader of the kernel's roofline share.

On the card (``cuda``): the kernel against the plain version — f1–f12
within 1e-12 of each feature's largest magnitude, f13 through its square
``1 − exp(−2δ)`` within 1e-12 (the root magnifies the rounding of δ without
bound near δ = 0: a matrix of one row, whose δ is 0, reads f13 ~1e-7 at
L = 1024 on either version), P and its marginals within L · 2⁻⁵³ (a
marginal sums L entries in another order) — at L from 2 to 1024, twice the
same bits, and one launch a plan call.

Against the JAX reference (``repro.core.haralick`` in float64), through a
stored file, on either device: the tail's route from counts, with and
without the float32 step, and two plans, at the tolerances of
``test_torch_haralick.py``.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import op_lint  # noqa: E402
from repro_torch.core import backends as _backends  # noqa: E402
from repro_torch.core.haralick import FEATURE_NAMES, haralick_features  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.kernels import build, mcc_kernel, tail_kernel  # noqa: E402
from repro_torch.kernels.tail_kernel import haralick_tail, haralick_tail_plain  # noqa: E402
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("random", "band", "one_row", "one_column", "single", "zero")
RTOL, P_ULP = 1e-12, 2.0**-53  # P, px, py: within L units of 2**-53
F3_RTOL_WINDOWS = 1e-9  # f3 on real windows (see the texture-map test)


def _counts(kind: str, levels: int, n: int = 3, seed: int = 0) -> torch.Tensor:
    """(n, L, L) int32 counts of one kind: iid, on a diagonal band (a smooth
    image's), in one row or one column (a marginal on one level: f3's
    guard), a single entry, or none."""
    rng = np.random.default_rng(seed + levels)
    L = levels
    c = np.zeros((n, L, L), np.int64)
    if kind == "random":
        c = rng.integers(0, 50, size=(n, L, L))
    elif kind == "band":
        i = np.arange(L)
        band = np.abs(i[:, None] - i[None, :]) <= 2
        c = rng.integers(0, 200, size=(n, L, L)) * band
    elif kind == "one_row":
        c[:, rng.integers(0, L)] = rng.integers(0, 50, size=(n, L))
    elif kind == "one_column":
        c[:, :, rng.integers(0, L)] = rng.integers(0, 50, size=(n, L))
    elif kind == "single":
        c[:, rng.integers(0, L), rng.integers(0, L)] = 7
    return torch.from_numpy(c.astype(np.int32))


def _float32_step(counts: torch.Tensor) -> torch.Tensor:
    """What ``core.plan``'s tail hands the features with ``normalize``."""
    p = counts.to(torch.float32)
    return p / p.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)


# ---------------------------------------------------------------------------
# The plain version, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [2, 3, 8, 32, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_the_pytorch_tail(kind, levels):
    """Counts as the features normalize them: the 13 features of
    ``haralick_features`` on the counts in float64, bit for bit, and its P."""
    counts = _counts(kind, levels)
    feats, p, px, py = haralick_tail(counts, with_p=True)
    assert feats.dtype == torch.float64 and feats.shape == (3, 13)
    want = haralick_features(counts.to(torch.float64))
    assert torch.equal(feats.to(torch.float32), want[:, :13])
    p_want = counts.to(torch.float64)
    p_want = p_want / p_want.sum(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    assert torch.equal(p, p_want)
    assert torch.equal(px, p_want.sum(dim=2)) and torch.equal(py, p_want.sum(dim=1))
    assert haralick_tail(counts)[1:] == (None, None, None)


@pytest.mark.parametrize("levels", [2, 3, 8, 32, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_the_pytorch_tail_after_the_float32_step(kind, levels):
    """A plan with ``normalize`` divides in float32 first: the features of
    that float32 P, bit for bit (its totals lie below 2**24, where the
    plan's float32 sum is exact)."""
    counts = _counts(kind, levels, seed=1)
    feats, p, _, _ = haralick_tail(counts, float32_step=True, with_p=True)
    p32 = _float32_step(counts)
    assert torch.equal(feats.to(torch.float32), haralick_features(p32)[:, :13])
    want = p32.to(torch.float64)
    assert torch.equal(p, want / want.sum(dim=(-2, -1), keepdim=True).clamp_min(1e-12))


@pytest.mark.parametrize("kind", ["one_row", "one_column", "single", "zero"])
def test_a_marginal_on_one_level_gives_f3_zero(kind):
    feats, *_ = haralick_tail(_counts(kind, 8))
    assert torch.equal(feats[:, 2], torch.zeros(3, dtype=torch.float64))
    assert torch.isfinite(feats).all()


def test_all_zero_counts_give_zero_features():
    feats, p, px, py = haralick_tail(_counts("zero", 8), with_p=True)
    assert not feats.abs().any() and not p.abs().any() and not px.any() and not py.any()


@pytest.mark.parametrize("select", [
    None,
    ("contrast", "asm_energy"),
    ("info_correlation_2", "max_correlation_coefficient", "correlation"),
    ("max_correlation_coefficient",),
    tuple(reversed(FEATURE_NAMES)),
])
@pytest.mark.parametrize("float32_step", [False, True])
def test_features_from_counts_equal_haralick_features(select, float32_step):
    """The plans' route, int32 counts through the tail (its plain version
    on the CPU): a (B, pairs, L, L) stack of counts → float32 features in
    ``select``'s order, f14 from the P the tail wrote, equal to those of
    the float64 counts, or of the plan's float32 P."""
    counts = torch.cat([_counts(k, 8, n=2) for k in KINDS]).reshape(3, 4, 8, 8)
    got = haralick_features(counts, select=select, float32_step=float32_step)
    src = _float32_step(counts) if float32_step else counts.to(torch.float64)
    want = haralick_features(src, select=select)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_plans_with_features_equal_the_tail_of_their_counts(symmetric, normalize):
    """A plan's features on the CPU (the tail's plain version, solver
    "plain") equal the PyTorch tail's on the same counts, or on the float32
    P a plan with ``normalize`` makes, bit for bit, symmetric or not."""
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform",
                    symmetric=symmetric, normalize=normalize)
    img = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 24, 24), np.uint8))
    counts = compile_plan(spec.replace(symmetric=False, normalize=False), (2, 24, 24),
                          device="cpu")(img)
    if symmetric:
        counts = counts + counts.transpose(-1, -2)
    got = compile_plan(spec, (2, 24, 24), features=True, device="cpu")(img)
    assert torch.equal(got, haralick_features(counts, float32_step=normalize))
    src = _float32_step(counts) if normalize else counts.to(torch.float64)
    assert torch.equal(got, haralick_features(src))


def test_counts_past_the_kernel_take_the_plain_version():
    """Wider than ``MAX_LEVELS`` int32 counts go to the plain version on
    either device: the PyTorch tail's features, and no launch."""
    L, select = tail_kernel.MAX_LEVELS + 6, ("contrast", "entropy", "correlation")
    counts = torch.zeros((1, L, L), dtype=torch.int32)
    counts[0, torch.arange(L), (torch.arange(L) * 7) % L] = torch.arange(1, L + 1, dtype=torch.int32)
    before = haralick_tail.launches
    got = haralick_features(counts, select=select, float32_step=True)
    assert torch.equal(got, haralick_features(_float32_step(counts), select=select))
    assert haralick_tail.launches == before


@pytest.mark.parametrize("kw", [dict(), dict(assume_normalized=True)])
def test_float32_step_takes_only_int32_counts(kw):
    counts = _counts("random", 8)
    src = counts.to(torch.float32) if not kw else counts
    with pytest.raises(ValueError, match="float32_step"):
        haralick_features(src, float32_step=True, **kw)


def test_plain_takes_a_batch_of_none():
    feats, p, px, py = haralick_tail(torch.zeros((0, 4, 4), dtype=torch.int32), with_p=True)
    assert feats.shape == (0, 13) and p.shape == (0, 4, 4) and px.shape == (0, 4)


@pytest.mark.parametrize("counts,match", [
    (torch.zeros((2, 4, 4), dtype=torch.float32), "int32"),
    (torch.zeros((2, 4, 4), dtype=torch.int64), "int32"),
    (torch.zeros((2, 4, 5), dtype=torch.int32), r"\(N, L, L\)"),
    (torch.zeros((4, 4), dtype=torch.int32), r"\(N, L, L\)"),
    (torch.zeros((2, 2, 4, 4), dtype=torch.int32), r"\(N, L, L\)"),
    (torch.zeros((2, 4, 4), dtype=torch.int32).transpose(-1, -2), "contiguous"),
    (torch.zeros((4, 8, 8), dtype=torch.int32)[::2], "contiguous"),
    (torch.zeros((2, 1, 1), dtype=torch.int32), "2 <= L <= 1024"),
    (torch.zeros((1, 1025, 1025), dtype=torch.int32), "2 <= L <= 1024"),
])
def test_haralick_tail_checks_its_arguments(counts, match):
    before = haralick_tail.launches
    with pytest.raises(ValueError, match=match):
        haralick_tail(counts)
    assert haralick_tail.launches == before


def test_plan_tail_solver_is_plain_on_the_cpu():
    """On the CPU a plan's tail is the PyTorch one: ``solver`` "plain" on
    ``plan.tail``, and the kernel never launches."""
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    before = haralick_tail.launches
    try:
        spec = GLCMSpec(levels=8, pairs=((1, 0),), quantize="uniform")
        img = np.random.default_rng(2).integers(0, 256, (2, 16, 16), np.uint8)
        for features in (True, ("contrast",)):
            compile_plan(spec, img.shape, features=features, device="cpu")(img)
        compile_plan(spec, img.shape, device="cpu")(img)
    finally:
        set_tracer(prev)
    tails = [s for s in tracer.spans() if s.name == "plan.tail"]
    assert [s.attrs for s in tails] == [{"matrices": 2, "solver": "plain"}] * 3
    assert haralick_tail.launches == before


@pytest.mark.parametrize("levels", [2, 32, 33, 256, 1024, 1025])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_of_the_features(device, levels):
    """``route`` decides from the device type and L alone: each kernel on
    the card within its range (L <= 1024), the plain versions on the CPU and
    past it. On the CPU it says what a call records: the ``solver`` of
    ``plan.tail`` (a plan, up to L = 256) and the ``solver`` and ``chunks``
    of ``haralick.eigvalsh``."""
    route = tail_kernel.route(device, levels)
    card, fits = device == "cuda" and levels <= 1024, levels <= 1024
    assert (route.tail, route.solver) == (("kernel", "kernel") if card else ("plain", "eigvalsh"))
    assert route.chunks(5) == (0 if card else mcc_kernel.eigvalsh_chunks(5, levels))
    assert route.tail_fn is (haralick_tail if fits else haralick_tail_plain)
    assert route.f14_fn is (mcc_kernel.second_eigenvalue if fits
                            else mcc_kernel.second_eigenvalue_plain)
    if device == "cuda":
        return
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        if levels <= 256:
            spec = GLCMSpec(levels=levels, pairs=((1, 0), (1, 90)), quantize="uniform")
            img = np.random.default_rng(levels).integers(0, 256, (2, 16, 16), np.uint8)
            compile_plan(spec, img.shape, features=True, device="cpu")(img)
        else:
            haralick_features(_counts("band", levels, n=1))
    finally:
        set_tracer(prev)
    eig = [s.attrs for s in tracer.spans() if s.name == "haralick.eigvalsh"]
    n = eig[0]["matrices"]
    assert eig == [{"matrices": n, "solver": route.solver, "chunks": route.chunks(n)}]
    tails = [s.attrs for s in tracer.spans() if s.name == "plan.tail"]
    assert tails == ([{"matrices": n, "solver": route.tail}] if levels <= 256 else [])


def test_device_kernel_launches_ignores_the_tail_kernel():
    """The tail kernel launches for any plan with features, so its launch
    alone does not show that the counts came from the card's kernels."""
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="cuda_fused")
    launches = {k.name: 0 for k in build.TABLE}
    assert "haralick_tail" in launches
    launches.update(haralick_tail=1, second_eigenvalue=1)
    ctx = op_lint.LintContext(
        record=op_lint.PlanRecord(ops=(), launches=launches), spec=spec,
        backend=_backends.get_backend("cuda_fused"), shape=(16, 16), dtype=torch.int32,
        device=torch.device("cuda"))
    msgs = op_lint.get_rule("device-kernel-launches").check(ctx)
    assert len(msgs) == 1 and "launched no kernel" in msgs[0]
    clean = dataclasses.replace(ctx, record=op_lint.PlanRecord(
        ops=(), launches={**launches, "glcm_fused": 1}))
    assert op_lint.get_rule("device-kernel-launches").check(clean) == []


# ---------------------------------------------------------------------------
# The benchmark's reader of the kernel's roofline share
# ---------------------------------------------------------------------------


def _reader():
    path = ROOT / "h100_bench" / "metrics" / "haralick_tail_roofline.py"
    spec = importlib.util.spec_from_file_location("haralick_tail_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(name):
    return json.loads((ROOT / "h100_bench" / "configs" / f"{name}.json").read_text())


def test_roofline_reader_counts_the_map_bytes():
    mod = _reader()
    cfg = _config("texture-map-4096-w32s16")
    assert mod.matrices(cfg, 1) == 260_100
    nbytes = mod.work(260_100, 32, True)
    assert nbytes == 260_100 * (32 * 32 * 4 + 13 * 8 + (32 * 32 + 64) * 8)
    name = ("void (anonymous namespace)::haralick_tail_kernel<0>(int const*, double*, "
            "double*, double*, double*, long long, int)")
    rec = {"config": cfg, "traffic": {"batch": 1},
           "trace": {"ops": {name: {"n": 3, "s": 6e-3}, "reduce_kernel": {"n": 9, "s": 1.0}}}}
    assert mod.read(rec) == pytest.approx(100 * 3 * nbytes / 3.35e12 / 6e-3)
    assert 0 < mod.read(rec) < 100


def test_roofline_reader_finds_nothing_without_the_kernel():
    mod = _reader()
    cfg = _config("paper-2d-4096-L32")
    assert mod.matrices(cfg, 8) == 32
    assert mod.read({"config": cfg, "traffic": {"batch": 8}, "trace": None}) is None
    rec = {"config": cfg, "traffic": {"batch": 8},
           "trace": {"ops": {"void at::native::reduce_kernel<512>(float)": {"n": 4, "s": 1e-3}}}}
    assert mod.read(rec) is None


# ---------------------------------------------------------------------------
# The kernel, on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _hold(got, want, f3_rtol=RTOL):
    """f1–f12 within RTOL of each feature's largest magnitude (f3 within
    ``f3_rtol``), f13 through its square, 1 − exp(−2δ), within RTOL; P, px
    and py within L · P_ULP."""
    scale = want[0].abs().amax(dim=0).clamp_min(1e-300)
    rel = (got[0] - want[0]).abs().amax(dim=0) / scale
    assert float(rel[[0, 1] + list(range(3, 12))].max()) <= RTOL, rel
    assert float(rel[2]) <= f3_rtol, rel
    assert float((got[0][:, 12] ** 2 - want[0][:, 12] ** 2).abs().max()) <= RTOL
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:  # a marginal sums L entries of at most 1, in another order
            assert g.shape == w.shape and float((g - w).abs().max()) <= g.shape[-1] * P_ULP


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [2, 3, 8, 31, 32, 33, 64, 256, 1024])
@pytest.mark.parametrize("float32_step", [False, True])
def test_kernel_equals_plain_on_card(levels, float32_step):
    _need_card()
    counts = torch.cat([_counts(k, levels, seed=levels) for k in KINDS]).to("cuda")
    for with_p in (True, False):
        before = haralick_tail.launches
        got = haralick_tail(counts, float32_step=float32_step, with_p=with_p)
        assert haralick_tail.launches == before + 1
        want = haralick_tail_plain(counts, float32_step=float32_step, with_p=with_p)
        _hold(got, want)
        again = haralick_tail(counts, float32_step=float32_step, with_p=with_p)
        assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "random"])
def test_kernel_on_texture_map_counts_on_card(kind):
    """A 1024² texture's windows (32² at stride 16, the paper's four pairs):
    the counts a texture map hands the tail. f3 is a difference of sums of
    order μxμy over σxσy, which a window of a smooth texture brings down to
    ~1e-3: there the two versions' rounding reads ~1e-10 apart."""
    _need_card()
    from repro_torch.core.glcm import PAPER_PAIRS
    from repro_torch.data.images import random_texture, smooth_texture

    make = smooth_texture if kind == "smooth" else random_texture
    img = torch.from_numpy(make(1024, seed=3).astype(np.float32)).to("cuda")
    spec = GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=32, region_stride=16)
    counts = compile_plan(spec, tuple(img.shape), device="cuda")(img).reshape(-1, 32, 32)
    _hold(haralick_tail(counts, with_p=True), haralick_tail_plain(counts, with_p=True),
          f3_rtol=F3_RTOL_WINDOWS)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kind", ["features", "texture_map", "normalized", "wide"])
def test_one_tail_launch_a_plan_call_on_card(plan_kind):
    """A plan with features on the card launches the tail kernel once a
    call, records ``solver`` "kernel" on ``plan.tail``, and gives the CPU
    plan's features within float32 rounding."""
    _need_card()
    levels = 256 if plan_kind == "wide" else 32
    kw = dict(levels=levels, pairs=((1, 0), (1, 45), (4, 0), (4, 45)), quantize="uniform")
    if plan_kind == "texture_map":
        kw.update(region="window", region_shape=32, region_stride=16)
    if plan_kind == "normalized":
        kw.update(normalize=True, symmetric=True)
    spec, shape = GLCMSpec(**kw), (2, 96, 96)
    img = torch.from_numpy(np.random.default_rng(5).integers(0, 256, shape, np.uint8))
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        plan = compile_plan(spec, shape, features=True, device="cuda")
        before = haralick_tail.launches
        got = plan(img.to("cuda"))
        torch.cuda.synchronize()
    finally:
        set_tracer(prev)
    assert haralick_tail.launches == before + 1
    assert [s.attrs["solver"] for s in tracer.spans() if s.name == "plan.tail"] == ["kernel"]
    want = compile_plan(spec, shape, features=True, device="cpu")(img)
    np.testing.assert_allclose(got.cpu().numpy()[..., :13], want.numpy()[..., :13],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.cpu().numpy()[..., 13], want.numpy()[..., 13], atol=1e-4)


@pytest.mark.cuda
def test_kernel_raises_on_card():
    """The card checks as the CPU does: no launch, no fallback."""
    _need_card()
    before = haralick_tail.launches
    for counts in (torch.zeros((2, 4, 4), dtype=torch.float32, device="cuda"),
                   torch.zeros((2, 4, 4), dtype=torch.int32, device="cuda").transpose(-1, -2),
                   torch.zeros((1, 1025, 1025), dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError):
            haralick_tail(counts)
    assert haralick_tail.launches == before
    empty = haralick_tail(torch.zeros((0, 8, 8), dtype=torch.int32, device="cuda"), with_p=True)
    assert empty[0].shape == (0, 13) and haralick_tail.launches == before


# ---------------------------------------------------------------------------
# The port against the JAX reference, on either device
# ---------------------------------------------------------------------------
#
# A machine with a card may have no JAX, so the reference's float64 features
# (``repro.core.haralick`` on the reference's own counts) are stored in
# ``data/tail_reference.json``: one test recomputes them with JAX and holds
# the file to them, the others hold the port to the file on the CPU and on
# the card. The inputs are made from an integer hash, not a random
# generator, so every machine makes the same ones. Regenerate the file with
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_tail_kernel.py``.

REFERENCE = Path(__file__).with_name("data") / "tail_reference.json"
REF_LEVELS, REF_KINDS = (8, 32, 256), ("random", "band", "one_row")
REF_SHAPE = (2, 48, 48)
REF_SELECT = ("max_correlation_coefficient", "correlation", "info_correlation_2", "contrast")
# The plans: glcm_features (all 14, the paper's pairs), and a symmetric plan
# with normalize and a subset, whose tail takes the float32 step.
REF_PLANS = {
    "glcm_features-L32": dict(levels=32, select=None, symmetric=False, normalize=False),
    "sym-norm-L256": dict(levels=256, select=REF_SELECT, symmetric=True, normalize=True),
}
REF_PAIRS = ((1, 0), (1, 45), (4, 0), (4, 45))
J_RTOL, J_ATOL, J_F14_ATOL = 1e-5, 1e-6, 1e-4  # tests/test_torch_haralick.py's


def _hashed(shape, salt: int) -> np.ndarray:
    """Integers in [0, 2**32) from the index alone (a 32-bit mix)."""
    with np.errstate(over="ignore"):
        k = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(salt) * np.uint64(0x9E3779B9)
        h = (k * np.uint64(0x85EBCA6B)) % np.uint64(2**32)
        h = ((h ^ (h >> np.uint64(13))) * np.uint64(0xC2B2AE35)) % np.uint64(2**32)
        h ^= h >> np.uint64(16)
    return h.reshape(shape).astype(np.int64)


def _ref_counts(kind: str, levels: int) -> np.ndarray:
    """(2, L, L) int32 counts: iid, on a band |i − j| ≤ 2, or in one row
    (a marginal on one level, where the port's f3 is 0)."""
    L, salt = levels, levels * 10 + REF_KINDS.index(kind)
    h = _hashed((2, L, L), salt)
    if kind == "random":
        c = h % 50
    elif kind == "band":
        i = np.arange(L)
        c = (h % 200) * (np.abs(i[:, None] - i[None, :]) <= 2)
    else:
        c = np.zeros((2, L, L), np.int64)
        c[:, salt % L] = h[:, 0] % 50
    return c.astype(np.int32)


def _ref_image() -> np.ndarray:
    return (_hashed(REF_SHAPE, 7) % 256).astype(np.uint8)


def _ref_key(kind: str, levels: int, float32_step: bool) -> str:
    return f"{kind}-L{levels}-{'f32' if float32_step else 'counts'}"


def _numpy_float32_step(counts: np.ndarray) -> np.ndarray:
    p = counts.astype(np.float32)
    return p / np.maximum(p.sum(axis=(-2, -1), keepdims=True), np.float32(1.0))


def _jax_reference() -> dict:
    """The stored file's contents, computed with the JAX reference in float64."""
    import jax
    import jax.numpy as jnp
    from jax import experimental as jax_experimental

    from repro.core import haralick as jh
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec

    legacy = getattr(jax_experimental, "enable_x64", None)

    def features(src, select=None):
        with legacy() if legacy is not None else jax.enable_x64(True):
            f = jh.haralick_features(jnp.asarray(np.asarray(src, np.float64)), select=select)
            return np.array(f, np.float64)

    out = {"counts": {}, "plans": {}}
    for levels in REF_LEVELS:
        for kind in REF_KINDS:
            c = _ref_counts(kind, levels)
            for step in (False, True):
                f = features(_numpy_float32_step(c) if step else c)
                if kind == "one_row":  # the reference's f3 is 0/0 there: rounding noise
                    f[:, 2] = np.nan
                out["counts"][_ref_key(kind, levels, step)] = _as_json(f)
    img = _ref_image()
    for name, case in REF_PLANS.items():
        jspec = JaxSpec(levels=case["levels"], pairs=REF_PAIRS, quantize="uniform")
        c = np.asarray(jax_compile_plan(jspec, img.shape)(jnp.asarray(img)), np.float64)
        if case["symmetric"]:
            c = c + np.swapaxes(c, -1, -2)
        out["plans"][name] = _as_json(features(c, select=case["select"]))
    return out


def _as_json(f: np.ndarray) -> list:
    return [[None if np.isnan(v) else float(v) for v in row] for row in f.reshape(-1, f.shape[-1])]


def _stored() -> dict:
    return json.loads(REFERENCE.read_text())


def _hold_to_reference(got: torch.Tensor, want, select=None):
    """The port's float32 features within the reference's tolerances;
    a NaN in the file marks a value the port holds at 0 (f3's guard)."""
    names = select or FEATURE_NAMES
    got = got.cpu().numpy()
    want = np.asarray(want, np.float64).reshape(got.shape)  # null → NaN
    assert got.dtype == np.float32
    for k, name in enumerate(names):
        g, w = got[..., k], want[..., k]
        guarded = np.isnan(w)
        assert not g[guarded].any(), name
        tol = dict(rtol=0, atol=J_F14_ATOL) if name == "max_correlation_coefficient" else \
            dict(rtol=J_RTOL, atol=J_ATOL)
        np.testing.assert_allclose(g[~guarded], w[~guarded], err_msg=name, **tol)


def test_stored_reference_is_the_jax_reference():
    pytest.importorskip("jax")
    want, stored = _jax_reference(), _stored()
    assert stored.keys() == want.keys()
    for group in want:
        assert stored[group].keys() == want[group].keys()
        for key in want[group]:
            np.testing.assert_allclose(np.asarray(stored[group][key], np.float64),
                                       np.asarray(want[group][key], np.float64),
                                       rtol=1e-9, atol=1e-12, equal_nan=True, err_msg=key)


def _port_against_reference(device: str, kind: str, levels: int, float32_step: bool):
    counts = torch.from_numpy(_ref_counts(kind, levels)).to(device)
    got = haralick_features(counts, float32_step=float32_step)
    _hold_to_reference(got, _stored()["counts"][_ref_key(kind, levels, float32_step)])


def _plan_against_reference(device: str, name: str):
    from repro_torch.core.glcm import glcm_features

    case, img = REF_PLANS[name], torch.from_numpy(_ref_image()).to(device)
    if name.startswith("glcm_features"):
        got = glcm_features(img, case["levels"], REF_PAIRS, device=device)
    else:
        spec = GLCMSpec(levels=case["levels"], pairs=REF_PAIRS, quantize="uniform",
                        symmetric=case["symmetric"], normalize=case["normalize"])
        got = compile_plan(spec, REF_SHAPE, features=case["select"], device=device)(img)
    _hold_to_reference(got, _stored()["plans"][name], select=case["select"])


@pytest.mark.parametrize("float32_step", [False, True])
@pytest.mark.parametrize("kind", REF_KINDS)
@pytest.mark.parametrize("levels", REF_LEVELS)
def test_counts_match_the_reference(levels, kind, float32_step):
    _port_against_reference("cpu", kind, levels, float32_step)


@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_features_match_the_reference(name):
    _plan_against_reference("cpu", name)


@pytest.mark.cuda
@pytest.mark.parametrize("float32_step", [False, True])
@pytest.mark.parametrize("kind", REF_KINDS)
@pytest.mark.parametrize("levels", REF_LEVELS)
def test_kernel_route_matches_the_reference_on_card(levels, kind, float32_step):
    """The kernel route on the card (int32 counts: the tail
    kernel, then f14's on the P it wrote) against the JAX reference."""
    _need_card()
    before = haralick_tail.launches
    _port_against_reference("cuda", kind, levels, float32_step)
    assert haralick_tail.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_features_match_the_reference_on_card(name):
    """``glcm_features`` and a symmetric, normalized plan with a subset, on
    the card, against the JAX reference on the reference's counts."""
    _need_card()
    before = haralick_tail.launches
    _plan_against_reference("cuda", name)
    assert haralick_tail.launches == before + 1


def test_module_constants():
    assert tail_kernel.N_FEATURES == len(FEATURE_NAMES) - 1
    assert tail_kernel.WARP_LEVELS == 32 and tail_kernel.MAX_LEVELS == 1024


if __name__ == "__main__":
    REFERENCE.parent.mkdir(exist_ok=True)
    REFERENCE.write_text(json.dumps(_jax_reference(), allow_nan=False) + "\n")
