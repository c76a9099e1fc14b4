"""The port's persisted autotuner (``repro_torch.core.autotune``) on the CPU.

Counterparts of ``tests/test_autotune.py`` (winner search, the JSON sidecar
across processes, ``compile_plan`` consuming a winner, the plan cache) and
of the autotune test of ``tests/test_obs_integration.py``, with
``device="cpu"`` and each test on its own sidecar through
``REPRO_TORCH_AUTOTUNE_PATH``. Where the port differs from the reference,
the test pins the port's behaviour: CUDA backends are never candidates for
a CPU plan, batched "scatter" competes (its ``bincount`` scales with the
batch on the CPU), the grids hold every backend's default knobs, an
out-of-memory error is a skip, and the store is the port's own. Parity
tests hold tuned plans of both packages, each from its own store, to the
same counts. The ``cuda`` tests tune on the card and skip without one.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autotune, backends
from repro_torch.core.glcm import PAPER_PAIRS, VOLUME_PAIRS
from repro_torch.core.plan import compile_plan, plan_cache_clear, plan_cache_stats
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels import glcm_kernel
from repro_torch.kernels.ops import default_slab_d, default_tile_h
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import Tracer, set_tracer

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp
    from repro.core import autotune as jautotune
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.plan import plan_cache_clear as jax_plan_cache_clear
    from repro.core.spec import GLCMSpec as JaxSpec
    from test_torch_haralick import reference_features
except ImportError:
    jautotune = None

SPEC = GLCMSpec(levels=8, pairs=((1, 0),), quantize="uniform")
SHAPE = (2, 32, 32)
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
DEVICE_KERNELS = ("cuda", "cuda_fused", "cuda_volume")
RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4


@pytest.fixture
def sidecar(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH", str(path))
    autotune.autotune_clear()
    plan_cache_clear()
    yield path
    autotune.autotune_clear()
    plan_cache_clear()


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    yield tr
    set_tracer(prev)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _need_reference():
    if jautotune is None:
        pytest.skip("needs JAX to run the reference")


def _images(shape, seed=0):
    """Float32 intensities in [0, 255): a smooth image and a random one per
    pair of batch entries."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 255.0
    smooth = np.cumsum(np.cumsum(rng.normal(size=shape), axis=-1), axis=-2)
    smooth = (smooth - smooth.min()) / np.ptp(smooth) * 255.0
    if len(shape) > 2:
        x[::2] = smooth[::2]
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_autotune.py
# ---------------------------------------------------------------------------


def test_store_path_env_override(sidecar):
    assert autotune.store_path() == sidecar


def test_autotune_records_and_persists(sidecar):
    choice = autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    assert choice.backend in backends.available_backends()
    assert sidecar.exists()
    table = json.loads(sidecar.read_text())
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    assert key in table
    assert table[key]["backend"] == choice.backend
    assert table[key]["us"] > 0


def test_lookup_returns_winner_and_validates(sidecar):
    autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is not None
    # a corrupted entry (unknown backend / foreign knobs / a knob value the
    # spec refuses) is ignored, never trusted
    table = json.loads(sidecar.read_text())
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    for entry in ({"backend": "no_such_backend", "knobs": {}},
                  {"backend": "onehot", "knobs": {"bogus_knob": 3}},
                  {"backend": "onehot", "knobs": {"copies": 0}},
                  {"backend": ["onehot"], "knobs": {}}):
        table[key] = entry
        sidecar.write_text(json.dumps(table))
        autotune.autotune_clear()
        assert autotune.lookup(SPEC, SHAPE, device=CPU) is None, entry


def test_tune_key_canonicalizes_knobs(sidecar):
    """The key identifies the WORKLOAD: knob settings must not change it."""
    base = autotune.tune_key(SPEC, SHAPE, device=CPU)
    for knobs in ({"copies": 4}, {"scheme": "onehot"}, {"chunk": 1024},
                  {"batch_mode": "unroll"}, {"tile_h": 16}, {"slab_d": 16},
                  {"num_blocks": 2}):
        assert autotune.tune_key(SPEC.replace(**knobs), SHAPE, device=CPU) == base
    # ...while genuine workload changes DO
    assert autotune.tune_key(SPEC.replace(levels=32), SHAPE, device=CPU) != base
    assert autotune.tune_key(SPEC, (4, 32, 32), device=CPU) != base
    assert autotune.tune_key(SPEC, SHAPE, ("volumetric",), device=CPU) != base
    assert json.loads(base)["device"] == "cpu"


def test_candidates_measure_no_batch_topology():
    """The reference measures ``batch_mode="unroll"`` for batched Pallas
    workloads; the CUDA kernels always carry the batch on their grid and no
    backend reads the knob, so no grid holds it, batched or not."""
    vol = GLCMSpec(levels=8, pairs=((1, 0), (1, 4)), ndim=3)
    for spec, shapes, names in ((SPEC, ((8, 32, 32), (32, 32)), ("cuda", "cuda_fused")),
                                (vol, ((4, 8, 16, 16), (8, 16, 16)), ("cuda_volume",))):
        for shape in shapes:
            for name in names:
                grid = autotune._candidates(spec, shape, name)
                assert grid and not any("batch_mode" in c for c in grid), (name, shape)
    assert autotune._candidates(SPEC, (8, 32, 32), "cuda") == autotune._candidates(
        SPEC, (32, 32), "cuda")


def test_lookup_accepts_persisted_batch_mode_winner(sidecar):
    """A sidecar entry carrying the batch_mode knob survives lookup's knob
    validation (knobs ⊆ KNOB_DEFAULTS)."""
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    sidecar.write_text(json.dumps({
        key: {"backend": "onehot", "knobs": {"copies": 2, "batch_mode": "unroll"}, "us": 1.0}
    }))
    autotune.autotune_clear()
    got = autotune.lookup(SPEC, SHAPE, device=CPU)
    assert got is not None
    assert dict(got.knobs)["batch_mode"] == "unroll"
    tuned = got.apply(SPEC)
    assert tuned.batch_mode == "unroll" and tuned.scheme == "onehot"


def test_compile_plan_consumes_winner_and_caches(sidecar):
    choice = autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    plan_cache_clear()
    p1 = compile_plan(SPEC, SHAPE, device=CPU)
    assert p1.tuned == choice
    assert p1.spec.scheme == choice.backend
    for knob, value in choice.knobs:
        assert getattr(p1.spec, knob) == value
    # the second compile of the tuned plan is a cache HIT on the same object
    p2 = compile_plan(SPEC, SHAPE, device=CPU)
    assert p2 is p1
    stats = plan_cache_stats()
    assert stats["hits"] >= 1 and stats["misses"] >= 1


def test_named_scheme_ignores_winner(sidecar):
    autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    plan = compile_plan(SPEC.replace(scheme="scatter"), SHAPE, device=CPU)
    assert plan.tuned is None
    assert plan.spec.scheme == "scatter"


def test_retune_misses_to_fresh_plan(sidecar):
    """A NEW winner must not serve the stale plan: the tuned choice is part
    of the cache key."""
    autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    p1 = compile_plan(SPEC, SHAPE, device=CPU)
    table = autotune._store()
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    other = "scatter" if p1.spec.scheme != "scatter" else "onehot"
    table[key] = {"backend": other, "knobs": {}}
    p2 = compile_plan(SPEC, SHAPE, device=CPU)
    assert p2 is not p1
    assert p2.spec.scheme == other


def test_winner_survives_process_boundary(sidecar):
    """A FRESH python process consumes the winner without re-measuring."""
    choice = autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "from repro_torch.core.plan import compile_plan\n"
        "from repro_torch.core.spec import GLCMSpec\n"
        "from repro_torch.obs.trace import Tracer, set_tracer\n"
        "tr = Tracer(enabled=True); set_tracer(tr)\n"
        "spec = GLCMSpec(levels=8, pairs=((1, 0),), quantize='uniform')\n"
        "plan = compile_plan(spec, (2, 32, 32), device='cpu')\n"
        "assert plan.tuned is not None, 'winner not consumed'\n"
        f"assert plan.tuned.backend == {choice.backend!r}, plan.tuned\n"
        "assert not [s for s in tr.spans() if s.name.startswith('autotune.')]\n"
        "print('consumed', plan.tuned.backend)\n"
    )
    env = dict(os.environ, REPRO_TORCH_AUTOTUNE_PATH=str(sidecar))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "consumed" in r.stdout


def test_autotune_clear_disk(sidecar):
    autotune.autotune(SPEC, SHAPE, trials=1, device=CPU)
    assert sidecar.exists()
    autotune.autotune_clear(disk=True)
    assert not sidecar.exists()
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is None


def test_missing_sidecar_is_not_an_error(sidecar):
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is None
    plan = compile_plan(SPEC, SHAPE, device=CPU)  # "auto" falls back to the rule
    assert plan.tuned is None and plan.spec.scheme == "onehot"


def test_corrupt_sidecar_is_ignored(sidecar):
    sidecar.write_text("{not json")
    autotune.autotune_clear()
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is None
    sidecar.write_text("[1, 2]")  # valid JSON, not a table
    autotune.autotune_clear()
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is None


def test_tuned_choice_apply():
    choice = autotune.TunedChoice(backend="onehot", knobs=(("copies", 4),))
    spec = choice.apply(SPEC)
    assert spec.scheme == "onehot" and spec.copies == 4
    fused = autotune.TunedChoice("cuda_fused", (("copies", 2), ("tile_h", None))).apply(SPEC)
    assert (fused.scheme, fused.copies, fused.tile_h) == ("cuda_fused", 2, None)


def test_autotune_reports_skipped_candidates(sidecar, monkeypatch):
    """An expected rejection (ValueError at plan/measure time) surfaces in
    report['skipped']; the search still finds a winner among the rest."""
    real = autotune._time_plan

    def flaky(plan, x, trials):
        if plan.backend.name == "scatter":
            raise ValueError("injected: scatter cannot serve this workload")
        return real(plan, x, trials)

    monkeypatch.setattr(autotune, "_time_plan", flaky)
    report: dict = {}
    choice = autotune.autotune(SPEC, (32, 32), trials=1, report=report, device=CPU)
    assert choice.backend != "scatter"
    rejected = [r["backend"] for r in report["skipped"]]
    assert rejected == ["scatter"]
    assert "injected" in report["skipped"][0]["reason"]
    assert "scatter" not in {r["backend"] for r in report["measured"]}


@pytest.mark.parametrize("shape", [SHAPE, (32, 32)])
def test_autotune_keeps_batched_scatter_in_search(sidecar, shape):
    """The reference keeps batched scatter out of its CPU search (XLA-CPU's
    scatter-add is sublinear in the batch). The port's scatter is one
    ``bincount`` that scales with the batch, so it is measured batched and
    unbatched alike and is never skipped."""
    report: dict = {}
    autotune.autotune(SPEC, shape, trials=1, report=report, device=CPU)
    assert not report["skipped"]
    rows = [r for r in report["measured"] if r["backend"] == "scatter"]
    assert len(rows) == 1 and rows[0]["knobs"] == {} and rows[0]["us"] > 0


def test_autotune_crash_propagates(sidecar, monkeypatch):
    """A crash that is NOT an expected rejection escapes the search."""
    def boom(plan, x, trials):
        raise RuntimeError("injected measurement bug")

    monkeypatch.setattr(autotune, "_time_plan", boom)
    with pytest.raises(RuntimeError, match="injected measurement bug"):
        autotune.autotune(SPEC, SHAPE, trials=1, persist=False, device=CPU)
    assert not autotune._store()


# ---------------------------------------------------------------------------
# Counterpart of tests/test_obs_integration.py's autotune test
# ---------------------------------------------------------------------------


def test_autotune_emits_run_and_candidate_spans(tracer, sidecar):
    reg = get_registry()
    reg.clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),), quantize="uniform")
    choice = autotune.autotune(spec, (16, 16), trials=1, persist=False, device=CPU)
    spans = tracer.spans()
    run = next(s for s in spans if s.name == "autotune.run")
    cands = [s for s in spans if s.name == "autotune.candidate"]
    assert cands, "every measured candidate records a span"
    assert run.attrs["winner"] == choice.backend
    assert run.attrs["candidates"] == len(cands)
    assert run.attrs["skipped"] == 0
    # candidate runtimes land in the µs-scale histogram, per backend
    series = reg.snapshot()["repro_autotune_candidate_us"]["series"]
    assert sum(s["count"] for s in series) == len(cands)
    assert {s["labels"]["backend"] for s in series} <= {s.attrs["backend"] for s in cands}
    assert "repro_autotune_candidate_us_bucket" in reg.to_prometheus()


def test_skipped_candidate_emits_event(tracer, sidecar, monkeypatch):
    real = autotune._time_plan

    def flaky(plan, x, trials):
        if plan.backend.name == "native":
            raise NotImplementedError("injected")
        return real(plan, x, trials)

    monkeypatch.setattr(autotune, "_time_plan", flaky)
    autotune.autotune(SPEC, SHAPE, trials=1, persist=False, device=CPU)
    events = [s for s in tracer.spans() if s.name == "autotune.skipped"]
    assert [(e.attrs["backend"], e.attrs["reason"]) for e in events] == [
        ("native", "NotImplementedError")]
    run = next(s for s in tracer.spans() if s.name == "autotune.run")
    assert run.attrs["skipped"] == 1


# ---------------------------------------------------------------------------
# Where the port differs: devices, grids, memory, the store
# ---------------------------------------------------------------------------


def test_cuda_backends_never_candidates_for_cpu_plan(sidecar):
    for name in DEVICE_KERNELS:
        assert backends.get_backend(name).caps.device_kernel
    others = set(backends.available_backends()) - set(DEVICE_KERNELS)
    assert not any(backends.get_backend(n).caps.device_kernel for n in others)
    for spec, shape in ((SPEC, SHAPE),
                        (GLCMSpec(levels=8, pairs=PAPER_PAIRS, quantize="uniform"), SHAPE),
                        (GLCMSpec(levels=8, pairs=((1, 0), (1, 4)), ndim=3), (6, 8, 8))):
        report: dict = {}
        autotune.autotune(spec, shape, trials=1, persist=False, report=report, device=CPU)
        rows = report["measured"] + report["skipped"]
        assert not {r["backend"] for r in rows} & set(DEVICE_KERNELS)
        assert {"native", "onehot", "scatter"} <= {r["backend"] for r in report["measured"]}


def test_foreign_device_entries_are_ignored(sidecar):
    """A CUDA backend's winner stored under the CPU key (a hand-edited
    sidecar) is ineligible there; an entry stored under another device's
    key is never found."""
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    foreign = key.replace('"device": "cpu"', '"device": "cuda:NVIDIA H100 80GB HBM3"')
    assert foreign != key
    sidecar.write_text(json.dumps({
        key: {"backend": "cuda", "knobs": {"copies": 2}},
        foreign: {"backend": "onehot", "knobs": {"copies": 4}},
    }))
    autotune.autotune_clear()
    assert autotune.lookup(SPEC, SHAPE, device=CPU) is None
    assert compile_plan(SPEC, SHAPE, device=CPU).spec.scheme == "onehot"


def _effective(spec):
    """``spec`` with each None knob replaced by the kernel default it means."""
    offsets = spec.offsets()
    return spec.replace(
        chunk=spec.chunk or glcm_kernel.DEFAULT_CHUNK,
        tile_h=spec.tile_h or (default_tile_h(offsets) if spec.ndim == 2 else None),
        slab_d=spec.slab_d or (default_slab_d(offsets) if spec.ndim == 3 else None))


_DEFAULTS = {  # each backend's knobs in an untuned "auto" plan
    "cuda": {"chunk": None, "copies": 1},
    "cuda_fused": {"tile_h": None, "copies": 1},
    "cuda_volume": {"slab_d": None, "copies": 1},
    "onehot": {"copies": 1},
    "blocked": {"num_blocks": 4},
    "scatter": {},
    "native": {},
}


_GRID_WORKLOADS = [
    (SPEC, SHAPE),
    (GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform"), (8, 64, 64)),
    (GLCMSpec(levels=32, pairs=((9, 0), (1, 45)), quantize="uniform"), (64, 64)),
    (GLCMSpec(levels=8, pairs=PAPER_PAIRS, region="window", region_shape=16,
              region_stride=8), (64, 64)),
    (GLCMSpec(levels=32, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3), (2, 16, 32, 32)),
    (GLCMSpec(levels=8, pairs=((12, 4),), ndim=3), (32, 16, 16)),
]


@pytest.mark.parametrize("name,spec,shape", [
    (name, spec, shape) for name in sorted(_DEFAULTS) for spec, shape in _GRID_WORKLOADS
    if backends.supports_ndim(backends.get_backend(name), spec.ndim)])
def test_default_knobs_are_candidates(name, spec, shape):
    """Every grid holds its backend's default knobs, so the winner is never
    a setting the untuned choice beat in the same run; a grid holds no
    duplicate and only knobs the spec accepts."""
    grid = autotune._candidates(spec, shape, name)
    specs = [spec.replace(scheme=name, **knobs) for knobs in grid]
    effective = [_effective(s) for s in specs]
    assert len(set(effective)) == len(effective), grid
    assert all(set(k) <= set(autotune.KNOB_DEFAULTS) for k in grid)
    default = spec.replace(scheme=name, **_DEFAULTS[name])
    if name == "blocked":
        n0 = shape[-spec.ndim] if spec.region == "global" else spec.region_shape[0]
        if n0 % 4 or max(o[0] for o in spec.offsets()) > n0 // 4:
            return  # the default cannot serve the workload either
    assert default in specs


def test_oom_is_a_skip_runtime_error_propagates(sidecar, monkeypatch):
    real = autotune._time_plan
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))

    def oom(plan, x, trials):
        if plan.backend.name == "onehot" and plan.spec.copies == 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 34 GiB")
        return real(plan, x, trials)

    monkeypatch.setattr(autotune, "_time_plan", oom)
    report: dict = {}
    autotune.autotune(SPEC, SHAPE, trials=1, persist=False, report=report, device=CPU)
    assert report["skipped"] == [{"backend": "onehot", "knobs": {"copies": 4},
                                  "reason": "OutOfMemoryError: CUDA out of memory. Tried to "
                                            "allocate 34 GiB"}]
    assert emptied == [1]

    def launch_failure(plan, x, trials):
        raise RuntimeError("glcm_fused kernel launch failed: CUDA error 700")

    monkeypatch.setattr(autotune, "_time_plan", launch_failure)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.autotune(SPEC, SHAPE, trials=1, persist=False, device=CPU)


def test_store_paths_are_independent(tmp_path, monkeypatch):
    """The port's sidecar is its own: a separate default path and a separate
    override variable, each of which leaves the other package's path."""
    _need_reference()
    monkeypatch.delenv("REPRO_AUTOTUNE_PATH", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_PATH", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    port_default, ref_default = autotune.store_path(), jautotune.store_path()
    assert port_default == tmp_path / "repro-glcm-torch" / "autotune.json"
    assert port_default != ref_default
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH", str(tmp_path / "port.json"))
    assert autotune.store_path() == tmp_path / "port.json"
    assert jautotune.store_path() == ref_default
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_PATH")
    monkeypatch.setenv("REPRO_AUTOTUNE_PATH", str(tmp_path / "ref.json"))
    assert jautotune.store_path() == tmp_path / "ref.json"
    assert autotune.store_path() == port_default


@pytest.mark.parametrize("backend,knobs", [("onehot", {"copies": 2}),
                                           ("blocked", {"num_blocks": 2})])
@pytest.mark.parametrize("pairs", [((1, 0),), PAPER_PAIRS])
def test_tuned_plans_equal_reference(tmp_path, monkeypatch, backend, knobs, pairs):
    """The same winner in each package's own store: the port's tuned plan
    gives the reference tuned plan's counts bit for bit, and features within
    rtol 1e-5 / atol 1e-6 (f14 1e-4) of the reference's formulas in float64
    on the reference's counts."""
    _need_reference()
    shape = (3, 32, 32)
    spec = GLCMSpec(levels=8, pairs=pairs, quantize="uniform")
    jspec = JaxSpec(levels=8, pairs=pairs, quantize="uniform")
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH", str(port_path))
    monkeypatch.setenv("REPRO_AUTOTUNE_PATH", str(ref_path))
    entry = {"backend": backend, "knobs": knobs, "us": 1.0}
    port_path.write_text(json.dumps({autotune.tune_key(spec, shape, device=CPU): entry}))
    ref_path.write_text(json.dumps({jautotune.tune_key(jspec, shape): entry}))
    autotune.autotune_clear()
    jautotune.autotune_clear()
    plan_cache_clear()
    jax_plan_cache_clear()
    try:
        x = _images(shape)
        jcounts = jax_compile_plan(jspec, shape)
        tcounts = compile_plan(spec, shape, device=CPU)
        tfeats = compile_plan(spec, shape, features=True, device=CPU)
        want_choice = autotune.TunedChoice(backend, tuple(sorted(knobs.items())))
        assert tcounts.tuned == tfeats.tuned == want_choice
        assert jcounts.tuned.backend == backend and dict(jcounts.tuned.knobs) == knobs
        assert (tcounts.spec.scheme, tcounts.spec.copies, tcounts.spec.num_blocks) == (
            jcounts.spec.scheme, jcounts.spec.copies, jcounts.spec.num_blocks)
        want = np.asarray(jcounts(jnp.asarray(x)))
        got = tcounts(x).numpy()
        np.testing.assert_array_equal(got, want)
        f = tfeats(x).numpy()
        ref = reference_features(want)
        np.testing.assert_allclose(f[..., :13], ref[..., :13], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(f[..., 13], ref[..., 13], rtol=0, atol=F14_ATOL)
    finally:
        autotune.autotune_clear()
        jautotune.autotune_clear()
        plan_cache_clear()
        jax_plan_cache_clear()


# ---------------------------------------------------------------------------
# compile_plan around a winner
# ---------------------------------------------------------------------------


def test_temporal_plan_consults_store_by_frame_shape(sidecar):
    frame = (32, 32)
    choice = autotune.autotune(SPEC, frame, trials=1, device=CPU)
    stream = compile_plan(SPEC, frame, temporal_window=3, device=CPU)
    assert stream.tuned == choice and stream.spec == choice.apply(SPEC)
    assert compile_plan(SPEC, frame, temporal_window=3, device=CPU) is stream
    # a winner for the batched shape is not the frame's
    autotune.autotune_clear(disk=True)
    autotune._store()[autotune.tune_key(SPEC, (1,) + frame, device=CPU)] = {
        "backend": "scatter", "knobs": {}}
    assert compile_plan(SPEC, frame, temporal_window=3, device=CPU).tuned is None
    video = _images((5,) + frame)
    want = compile_plan(SPEC.replace(scheme="scatter"), frame, temporal_window=3,
                        device=CPU).rolling(video)
    assert torch.equal(stream.rolling(video), want)


def test_plan_cache_counts_one_lookup_per_compile(sidecar):
    reg = get_registry()
    reg.clear()
    compile_plan(SPEC, SHAPE, device=CPU)                      # miss, untuned
    autotune._store()[autotune.tune_key(SPEC, SHAPE, device=CPU)] = {
        "backend": "scatter", "knobs": {}}
    tuned = compile_plan(SPEC, SHAPE, device=CPU)              # miss, tuned
    assert compile_plan(SPEC, SHAPE, device=CPU) is tuned      # hit, tuned
    compile_plan(SPEC.replace(scheme="onehot"), SHAPE, device=CPU)  # miss, named
    series = reg.snapshot()["repro_plan_cache_lookups_total"]["series"]
    assert {s["labels"]["result"]: s["value"] for s in series} == {"miss": 3, "hit": 1}


def test_concurrent_lookups_while_retuning(sidecar):
    """Threads compiling "auto" plans while winners change: every plan
    matches the choice it records and no thread fails."""
    table = autotune._store()
    key = autotune.tune_key(SPEC, SHAPE, device=CPU)
    winners = [{"backend": "scatter", "knobs": {}},
               {"backend": "onehot", "knobs": {"copies": 2}},
               {"backend": "blocked", "knobs": {"num_blocks": 2}}]
    table[key] = winners[0]
    errors, plans, stop = [], [], threading.Event()

    def worker():
        try:
            while not stop.is_set():
                plans.append(compile_plan(SPEC, SHAPE, device=CPU))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range((os.cpu_count() or 1) + 1)]
        for t in threads:
            t.start()
        for i in range(300):
            with autotune._LOCK:
                table[key] = winners[i % 3]
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert plans
    for p in plans:
        assert p.tuned is not None and p.spec == p.tuned.apply(SPEC)


def test_tuning_without_a_card_raises():
    """No fallback: ``device=None`` means the card, as in compile_plan."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune(SPEC, SHAPE, trials=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.lookup(SPEC, SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.main(["--size", "32x32", "--no-persist"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_WORKLOADS = [
    (GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform"), (2, 256, 256)),
    (GLCMSpec(levels=32, pairs=((1, 45),), quantize="uniform"), (512, 512)),
    (GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform", region="window",
              region_shape=32, region_stride=16), (256, 256)),
    (GLCMSpec(levels=32, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3), (2, 16, 64, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,shape", CARD_WORKLOADS)
def test_card_every_candidate_and_winner_equal_plain(sidecar, spec, shape):
    """Tune a small workload on the card: every device-kernel candidate was
    measured, and every measured candidate's plan, the winner's included,
    gives the plain "scatter" route's counts bit for bit."""
    _card()
    report: dict = {}
    choice = autotune.autotune(spec, shape, trials=1, report=report)
    names = {r["backend"] for r in report["measured"]}
    kernels = {n for n in DEVICE_KERNELS
               if backends.supports_ndim(backends.get_backend(n), spec.ndim)}
    assert kernels <= names
    x = torch.from_numpy(_images(shape)).cuda()
    want = compile_plan(spec.replace(scheme="scatter"), shape)(x)
    for row in report["measured"]:
        got = compile_plan(spec.replace(scheme=row["backend"], **row["knobs"]), shape)(x)
        assert torch.equal(got, want), row
    plan = compile_plan(spec, shape)
    assert plan.tuned == choice and plan.device.type == "cuda"
    json.loads(sidecar.read_text())  # persisted
    assert torch.equal(plan(x), want)


@pytest.mark.cuda
def test_card_cli_tunes_and_winner_launches(sidecar, capsys):
    _card()
    assert autotune.main(["--size", "512x512", "--batch", "2", "--pairs", "1:0,1:45",
                          "--quantize", "uniform", "--trials", "1"]) == 0
    assert "winner:" in capsys.readouterr().out
    spec = GLCMSpec(levels=32, pairs=((1, 0), (1, 45)), quantize="uniform")
    plan = compile_plan(spec, (2, 512, 512))
    assert plan.tuned is not None
    kernel = {"cuda": glcm_kernel.glcm_vote, "cuda_fused": glcm_kernel.glcm_fused}.get(
        plan.tuned.backend)
    before = kernel.launches if kernel else 0
    plan(torch.from_numpy(_images((2, 512, 512))).cuda())
    torch.cuda.synchronize()
    if kernel:
        assert kernel.launches > before
