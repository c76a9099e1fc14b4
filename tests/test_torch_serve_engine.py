"""The continuous-batching GLCMEngine of repro_torch against the reference.

Counterparts of ``tests/test_serve_engine.py`` (deadline dispatch, multi-spec
multiplexing, priorities, backpressure, bounded results, stream coexistence)
and of the engine tests of ``tests/test_stream_state.py`` (sessions,
checkpoints, guards), on the CPU (``device="cpu"``). Deadline tests inject a
fake clock, so expiry is deterministic virtual time, never a sleep.

Parity with ``repro.serve.engine.GLCMEngine``: the same seeded numpy requests
go through both engines, with configs built from one ``dataclasses.asdict``
of the reference's config (``GLCMServeConfig.from_dict``). Counts must be
identical; features are held to the reference's formulas evaluated in
float64 on the reference's counts (rtol 1e-5 / atol 1e-6, f14 atol 1e-4;
ROADMAP Queue 3), not to its float32 features. Every request dtype the
engine admits gives the reference's counts. A stream session, closed and
resumed from its ``state_dict()`` mid-stream, follows the reference engine:
its pushes within rtol 1e-5 (f14 atol 1e-4) of the reference's formulas in
float64 on the reference session's counts, and within rtol 1e-4 / atol 1e-5
of the reference's float32 pushes, whose own rounding of f3 and f12 reaches
3.6e-5 here (the reference's exact comparison of ``update`` with
``rolling`` fails under jax 0.9.0 for the same reason).

The two ``cuda`` tests run the engine's batched launch on the card and skip
where there is none.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import pad_stack
from repro_torch.core.plan import bucket_sizes, pick_bucket, plan_cache_clear
from repro_torch.core.spec import GLCMSpec
from repro_torch.core.stream_state import init_state
from repro_torch.serve.engine import GLCMEngine as _Engine
from repro_torch.serve.engine import GLCMServeConfig, QueueFullError

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core.spec import GLCMSpec as RefSpec
    from repro.serve.engine import GLCMEngine as RefEngine
    from repro.serve.engine import GLCMServeConfig as RefConfig
    from test_torch_haralick import reference_features
except ImportError:
    jnp = None

RNG = np.random.default_rng(7)
SHAPE = (32, 32)
IMGS = RNG.random((16, *SHAPE), np.float32)
VOLS = RNG.random((8, 4, 16, 16), np.float32)
RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4

SPEC_2D = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform")
SPEC_EQ = GLCMSpec(levels=8, pairs=((1, 0),), quantize="equalized")
SPEC_TILES = GLCMSpec(
    levels=8, pairs=((1, 0),), quantize="uniform",
    region="tiles", region_shape=(16, 16),
)
SPEC_VOL = GLCMSpec(levels=8, pairs=((1, 0),), quantize="uniform", ndim=3)

# The stream sessions of tests/test_stream_state.py.
S_LEVELS, S_SHAPE, S_WINDOW = 8, (20, 16), 4
S_T = 3 * S_WINDOW + 2  # the ring wraps three times
S_PAIRS = ((1, 0), (1, 135))


def GLCMEngine(cfg=GLCMServeConfig(), **kw):
    """The port's engine on the CPU."""
    return _Engine(cfg, device="cpu", **kw)


def _cfg(**kw):
    kw.setdefault("levels", 8)
    kw.setdefault("image_shape", SHAPE)
    kw.setdefault("pairs", ((1, 0),))
    return GLCMServeConfig(**kw)


def _video(t=S_T, shape=S_SHAPE, levels=S_LEVELS, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, (t, *shape)).astype(np.int32)


def _needs_reference():
    if jnp is None:
        pytest.skip("needs JAX to run the reference")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, ms):
        self.t += ms * 1e-3


# ---------------------------------------------------------------------------
# bucket helpers
# ---------------------------------------------------------------------------


def test_bucket_sizes_default_powers_of_two():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    assert bucket_sizes(1) == (1,)


def test_bucket_sizes_explicit_validated():
    assert bucket_sizes(8, (2, 8)) == (2, 8)
    with pytest.raises(ValueError, match="ascending"):
        bucket_sizes(8, (4, 2, 8))
    with pytest.raises(ValueError, match="end at the batch size"):
        bucket_sizes(8, (1, 2, 4))
    with pytest.raises(ValueError, match="positive"):
        bucket_sizes(8, (0, 8))


def test_pick_bucket_smallest_fit():
    assert pick_bucket((1, 2, 4, 8), 1) == 1
    assert pick_bucket((1, 2, 4, 8), 3) == 4
    assert pick_bucket((1, 2, 4, 8), 8) == 8
    with pytest.raises(ValueError, match="exceed"):
        pick_bucket((1, 2), 3)


def test_pad_stack_repeats_last():
    stack, k = pad_stack([IMGS[0], IMGS[1]], 4)
    assert stack.shape == (4, *SHAPE) and k == 2
    np.testing.assert_array_equal(stack[2], IMGS[1])
    np.testing.assert_array_equal(stack[3], IMGS[1])
    with pytest.raises(ValueError, match="1..2"):
        pad_stack([IMGS[0]] * 3, 2)


# ---------------------------------------------------------------------------
# deadline-driven dispatch
# ---------------------------------------------------------------------------


def test_deadline_dispatches_single_queued_request():
    """ONE queued request launches alone (padded to the smallest bucket)
    once its age reaches max_wait_ms — it never stalls behind an unfilled
    batch."""
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8, max_wait_ms=5.0), clock=clock)
    t = eng.submit(IMGS[0])
    assert eng.batches_dispatched == 0
    clock.advance(4.9)
    assert eng.poll() == 0          # deadline not reached: still queued
    clock.advance(0.2)
    assert eng.poll() == 1          # expired: partial dispatch fires
    entry = eng.dispatch_log[-1]
    assert entry["deadline"] and entry["bucket"] == 1 and entry["occupancy"] == 1
    assert eng.stats()["workloads"][0]["deadline_dispatches"] == 1
    ref = GLCMEngine(_cfg(batch_size=1)).map(IMGS[:1])[0]
    np.testing.assert_array_equal(eng.result(t), ref)


def test_deadline_none_preserves_legacy_wait_until_full():
    eng = GLCMEngine(_cfg(batch_size=4))
    for im in IMGS[:3]:
        eng.submit(im)
    assert eng.poll() == 0 and eng.batches_dispatched == 0
    eng.submit(IMGS[3])             # 4th request: full batch auto-dispatches
    assert eng.batches_dispatched == 1


def test_deadline_dispatch_takes_largest_full_bucket():
    """A deadline launch with 3 queued takes a FULL bucket-2 launch (the
    leftover's own deadline is later), not a padded bucket-4."""
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8, max_wait_ms=1.0), clock=clock)
    for im in IMGS[:3]:
        eng.submit(im)
    clock.advance(1.1)
    eng.poll()
    entry = eng.dispatch_log[-1]
    assert entry["bucket"] == 2 and entry["occupancy"] == 2
    occ = eng.stats()["workloads"][0]["batch_occupancy"]
    assert occ == {2: {2: 1}}
    # the leftover request is younger: its deadline fires later, alone
    clock.advance(1.1)
    eng.poll()
    assert eng.dispatch_log[-1]["bucket"] == 1
    # padding only below the smallest bucket: explicit buckets (2, 8),
    # one queued request past deadline → padded bucket-2 launch
    eng2 = GLCMEngine(
        _cfg(batch_size=8, buckets=(2, 8), max_wait_ms=1.0), clock=clock)
    eng2.submit(IMGS[0])
    clock.advance(1.1)
    eng2.poll()
    entry = eng2.dispatch_log[-1]
    assert entry["bucket"] == 2 and entry["occupancy"] == 1


def test_deadline_fires_inside_submit_too():
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8, max_wait_ms=1.0), clock=clock)
    eng.submit(IMGS[0])
    clock.advance(2.0)
    eng.submit(IMGS[1])             # submit advances the loop: both dispatch
    assert eng.batches_dispatched == 1
    assert eng.dispatch_log[-1]["occupancy"] == 2


def test_next_deadline_reports_earliest_expiry():
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8, max_wait_ms=5.0), clock=clock)
    assert eng.next_deadline() is None
    eng.submit(IMGS[0])
    clock.advance(2.0)
    eng.submit(IMGS[1])
    assert eng.next_deadline() == pytest.approx(5e-3)   # oldest sets it
    clock.t = eng.next_deadline()
    assert eng.poll() == 1
    assert eng.next_deadline() is None
    # no deadline configured → never reports one
    eng2 = GLCMEngine(_cfg(batch_size=8))
    eng2.submit(IMGS[0])
    assert eng2.next_deadline() is None


def test_per_workload_deadline_override():
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8), clock=clock)   # engine: no deadline
    wid = eng.register(SPEC_2D, SHAPE, max_wait_ms=1.0)
    eng.submit(IMGS[0])
    eng.submit(IMGS[1], workload=wid)
    clock.advance(5.0)
    assert eng.poll() == 1          # only the deadline workload fires
    assert eng.dispatch_log[-1]["workload"] == wid
    assert len(eng._workloads[0].queue) == 1


# ---------------------------------------------------------------------------
# multi-spec multiplexing
# ---------------------------------------------------------------------------


def test_mixed_spec_interleaved_bit_identical_to_dedicated_engines():
    """One engine serving 2-D + equalized + tiles-region + volume specs,
    submits interleaved, returns results bit-identical to four dedicated
    single-spec engines."""
    plan_cache_clear()
    eng = GLCMEngine(_cfg(spec=SPEC_2D, batch_size=2))
    wid_eq = eng.register(SPEC_EQ, SHAPE, batch_size=2)
    wid_tl = eng.register(SPEC_TILES, SHAPE, batch_size=2)
    wid_vol = eng.register(SPEC_VOL, (4, 16, 16), batch_size=2)
    assert eng.workloads() == (0, wid_eq, wid_tl, wid_vol)

    tickets = []
    for i in range(4):              # interleave: round-robin across specs
        tickets.append((eng.submit(IMGS[i]), 0, i))
        tickets.append((eng.submit(IMGS[i], workload=wid_eq), wid_eq, i))
        tickets.append((eng.submit(IMGS[i], workload=wid_tl), wid_tl, i))
        tickets.append((eng.submit(VOLS[i], workload=wid_vol), wid_vol, i))
    eng.flush()
    got = {(w, i): eng.result(t) for t, w, i in tickets}

    dedicated = {
        0: GLCMEngine(_cfg(spec=SPEC_2D, batch_size=2)).map(IMGS[:4]),
        wid_eq: GLCMEngine(_cfg(spec=SPEC_EQ, batch_size=2)).map(IMGS[:4]),
        wid_tl: GLCMEngine(_cfg(spec=SPEC_TILES, batch_size=2)).map(IMGS[:4]),
        wid_vol: GLCMEngine(
            _cfg(spec=SPEC_VOL, image_shape=(4, 16, 16), batch_size=2)
        ).map(VOLS[:4]),
    }
    for (w, i), out in got.items():
        np.testing.assert_array_equal(out, dedicated[w][i])
    # region workload really produced a texture map (grid axes present)
    assert got[(wid_tl, 0)].shape[:2] == (2, 2)


def test_workload_stats_are_per_workload():
    eng = GLCMEngine(_cfg(batch_size=2))
    wid = eng.register(SPEC_VOL, (4, 16, 16), batch_size=4)
    eng.map(IMGS[:4])
    eng.map(VOLS[:2], workload=wid)
    st = eng.stats()
    assert st["workloads"][0]["served"] == 4
    assert st["workloads"][0]["batches"] == 2
    assert st["workloads"][wid]["served"] == 2
    assert st["workloads"][wid]["ndim"] == 3
    for w in st["workloads"].values():
        for k in ("queue_ms", "service_ms", "e2e_ms"):
            assert {"p50", "p95", "p99", "mean", "n"} <= set(w[k])
        assert {"queue_depth", "shed", "batch_occupancy",
                "results_evicted"} <= set(w)
    assert 0.0 <= st["plan_cache"]["hit_rate"] <= 1.0


def test_register_validates_spec_and_shape():
    eng = GLCMEngine(_cfg())
    with pytest.raises(ValueError, match="GLCMSpec"):
        eng.register("scatter", SHAPE)
    with pytest.raises(ValueError, match="rank"):
        eng.register(SPEC_VOL, SHAPE)       # ndim=3 spec, 2-D shape
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(IMGS[0], workload=99)


def test_shared_plan_cache_across_engine_instances():
    """Two engines with equal specs on one device share plans — the
    registry resolves through the global LRU plan cache."""
    plan_cache_clear()
    a = GLCMEngine(_cfg(batch_size=4))
    b = GLCMEngine(_cfg(batch_size=4))
    assert a.plan is b.plan


# ---------------------------------------------------------------------------
# priorities + backpressure
# ---------------------------------------------------------------------------


def test_backpressure_sheds_at_max_queue_depth():
    eng = GLCMEngine(_cfg(batch_size=8, max_queue_depth=3))
    for im in IMGS[:3]:
        eng.submit(im)
    with pytest.raises(QueueFullError, match="max_queue_depth"):
        eng.submit(IMGS[3])
    st = eng.stats()["workloads"][0]
    assert st["shed"] == 1 and st["queue_depth"] == 3
    eng.flush()                      # draining reopens the queue
    eng.submit(IMGS[3])
    assert eng.stats()["workloads"][0]["shed"] == 1


def test_priorities_drain_high_before_low_under_load():
    eng = GLCMEngine(_cfg(batch_size=2))
    eng.pause()                      # build a backlog deterministically
    low = [eng.submit(im, priority=0) for im in IMGS[:4]]
    high = [eng.submit(im, priority=10) for im in IMGS[4:8]]
    assert eng.batches_dispatched == 0
    eng.resume()                     # backlog drains in priority order
    assert eng.batches_dispatched == 4
    order = [t for d in eng.dispatch_log for t in d["tickets"]]
    assert order[:4] == high and order[4:] == low
    # results are still correct per ticket despite reordering
    ref = GLCMEngine(_cfg(batch_size=2)).map(IMGS[:8])
    for i, t in enumerate(low):
        np.testing.assert_array_equal(eng.result(t), ref[i])


def test_priority_ageing_prevents_starvation():
    """With a deadline configured, queued age counts toward priority, and a
    deadline launch ALWAYS carries the oldest request."""
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=2, max_wait_ms=10.0), clock=clock)
    eng.pause()
    old = eng.submit(IMGS[0], priority=0)
    clock.advance(9.0)
    for im in IMGS[1:4]:
        eng.submit(im, priority=1)
    clock.advance(2.0)               # old request is past its deadline
    eng.resume()
    assert old in eng.dispatch_log[0]["tickets"]


# ---------------------------------------------------------------------------
# bounded result store
# ---------------------------------------------------------------------------


def test_result_store_bounded_evicts_oldest_and_counts():
    eng = GLCMEngine(_cfg(batch_size=1, max_results=4))
    tickets = [eng.submit(im) for im in IMGS[:7]]
    st = eng.stats()
    assert st["results_held"] == 4
    assert st["workloads"][0]["results_evicted"] == 3
    for t in tickets[:3]:            # oldest three evicted
        with pytest.raises(KeyError, match="evicted"):
            eng.result(t)
    for t in tickets[3:]:            # newest four retrievable, on the host
        assert isinstance(eng.result(t), np.ndarray)
    assert eng.stats()["results_held"] == 0


def test_result_is_one_shot_and_unknown_raises():
    eng = GLCMEngine(_cfg(batch_size=2))
    t = eng.submit(IMGS[0])
    eng.result(t)
    with pytest.raises(KeyError, match="already retrieved"):
        eng.result(t)
    with pytest.raises(KeyError, match="unknown"):
        eng.result(12345)


# ---------------------------------------------------------------------------
# streams coexist with continuous batch traffic
# ---------------------------------------------------------------------------


def test_stream_sessions_coexist_with_continuous_batching():
    clock = FakeClock()
    eng = GLCMEngine(
        _cfg(batch_size=4, temporal_window=2, max_wait_ms=1.0), clock=clock
    )
    sid = eng.open_stream()
    frames = [eng.push(sid, IMGS[i]) for i in range(3)]
    t = eng.submit(IMGS[5])          # batch request between pushes
    clock.advance(2.0)
    assert eng.poll() == 1           # deadline fires with the stream open
    frames.append(eng.push(sid, IMGS[3]))
    state = eng.close_stream(sid)

    # stream outputs unaffected by the interleaved batch traffic
    ref_eng = GLCMEngine(_cfg(batch_size=4, temporal_window=2))
    ref_sid = ref_eng.open_stream()
    for i, frame in zip((0, 1, 2, 3), frames):
        np.testing.assert_array_equal(frame, ref_eng.push(ref_sid, IMGS[i]))
    # batch result unaffected by the open stream
    np.testing.assert_array_equal(
        eng.result(t), GLCMEngine(_cfg(batch_size=1)).map(IMGS[5:6])[0]
    )
    assert state.window == 2 and state.counts.device.type == "cpu"
    assert eng.stats()["frames_streamed"] == 4


def test_engine_stream_sessions_and_checkpoint():
    video = _video()
    spec = GLCMSpec(levels=S_LEVELS, pairs=S_PAIRS, scheme="onehot", normalize=True)
    cfg = GLCMServeConfig(spec=spec, image_shape=S_SHAPE, batch_size=2,
                          temporal_window=S_WINDOW)
    eng = GLCMEngine(cfg)
    ref = eng.stream_plan.rolling(video).numpy()

    sid = eng.open_stream()
    cut = S_WINDOW + 1
    for t in range(cut):
        np.testing.assert_array_equal(eng.push(sid, video[t]), ref[t])
    state = eng.close_stream(sid)
    with pytest.raises(KeyError):
        eng.push(sid, video[0])

    # resume from the checkpoint (as a state_dict) in a NEW session
    sid2 = eng.open_stream(state=state.state_dict())
    for t in range(cut, S_T):
        np.testing.assert_array_equal(eng.push(sid2, video[t]), ref[t])
    assert eng.frames_streamed == S_T

    # the one-shot batch path still serves alongside the sessions
    assert eng.map(video[:2]).shape[0] == 2

    # validation is shared with submit: malformed frames fail at push time
    with pytest.raises(ValueError, match="frame shape"):
        eng.push(sid2, video[0][:-1])


def test_engine_stream_guards():
    spec = GLCMSpec(levels=S_LEVELS, pairs=S_PAIRS, scheme="onehot")
    plain = GLCMEngine(GLCMServeConfig(spec=spec, image_shape=S_SHAPE, batch_size=2))
    assert plain.stream_plan is None
    with pytest.raises(ValueError, match="temporal_window"):
        plain.open_stream()

    with pytest.raises(ValueError, match="temporal_window"):
        GLCMServeConfig(spec=spec, image_shape=S_SHAPE, temporal_window=0)

    eng = GLCMEngine(GLCMServeConfig(spec=spec, image_shape=S_SHAPE,
                                     batch_size=2, temporal_window=S_WINDOW))
    other = init_state(S_WINDOW + 2, (), len(S_PAIRS), S_LEVELS, device="cpu")
    with pytest.raises(ValueError, match="window"):
        eng.open_stream(state=other)


# ---------------------------------------------------------------------------
# config validation + misc
# ---------------------------------------------------------------------------


def test_config_validates_new_knobs_eagerly():
    with pytest.raises(ValueError, match="max_wait_ms"):
        _cfg(max_wait_ms=0.0)
    with pytest.raises(ValueError, match="max_queue_depth"):
        _cfg(max_queue_depth=0)
    with pytest.raises(ValueError, match="max_results"):
        _cfg(max_results=0)
    with pytest.raises(ValueError, match="buckets"):
        _cfg(batch_size=8, buckets=(3, 1, 8))
    with pytest.raises(ValueError, match="rank"):
        _cfg(spec=SPEC_VOL)          # ndim=3 spec, default 2-D image_shape


def test_warmup_precompiles_every_bucket():
    eng = GLCMEngine(_cfg(batch_size=4))
    eng.warmup()
    assert set(eng._workloads[0].plans) == {1, 2, 4}


def test_latencies_accessor():
    eng = GLCMEngine(_cfg(batch_size=2))
    eng.map(IMGS[:4])
    assert eng.latencies(0, "e2e").shape == (4,)
    assert eng.latencies(0, "service").shape == (4,)
    with pytest.raises(ValueError, match="kind"):
        eng.latencies(0, "bogus")


def test_default_device_is_the_card():
    """No ``device=``: the card, and without one a RuntimeError (no
    fallback to the CPU)."""
    if torch.cuda.is_available():
        assert _Engine(_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _Engine(_cfg())


def test_config_from_dict_roundtrip_and_unknown_keys():
    cfg = _cfg(spec=SPEC_TILES, batch_size=4, buckets=(2, 4), max_wait_ms=3.0,
               temporal_window=2, features=("contrast", "entropy"))
    assert GLCMServeConfig.from_dict(dataclasses.asdict(cfg)) == cfg
    assert GLCMServeConfig.from_dict({"batch_size": 2}) == GLCMServeConfig(batch_size=2)
    with pytest.raises(ValueError, match="unknown GLCMServeConfig fields"):
        GLCMServeConfig.from_dict({"batch": 2})


# ---------------------------------------------------------------------------
# parity with the reference engine
# ---------------------------------------------------------------------------

REF_SPECS = {  # the mixed four-workload engine, as reference specs
    "2d": dict(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform"),
    "eq": dict(levels=8, pairs=((1, 0),), quantize="equalized"),
    "tiles": dict(levels=8, pairs=((1, 0), (2, 90)), quantize="uniform", region="tiles",
                  region_shape=(16, 16)),
    "vol": dict(levels=8, pairs=((1, 0), (1, 7)), quantize="uniform", ndim=3),
}


def _mixed_engines(features):
    """The reference's and the port's mixed engines, the port's config and
    specs rebuilt from the reference's through ``asdict``."""
    ref_cfg = RefConfig(spec=RefSpec(**REF_SPECS["2d"]), image_shape=SHAPE, batch_size=2,
                        features=features)
    port_cfg = GLCMServeConfig.from_dict(dataclasses.asdict(ref_cfg))
    assert port_cfg.spec == GLCMSpec(**REF_SPECS["2d"])
    engines = [RefEngine(ref_cfg), GLCMEngine(port_cfg)]
    for name in ("eq", "tiles", "vol"):
        ref_spec = RefSpec(**REF_SPECS[name])
        shape = (4, 16, 16) if name == "vol" else SHAPE
        engines[0].register(ref_spec, shape, name=name)
        engines[1].register(GLCMSpec.from_dict(dataclasses.asdict(ref_spec)), shape,
                            name=name)
    return engines


def _serve_mixed(eng):
    """Interleaved requests (a deadline-free engine: full batches and a
    final flush of the partial ones) → {(workload, i): result}."""
    tickets = []
    for i in range(5):
        for wid in range(4):
            req = VOLS[i] if wid == 3 else IMGS[i]
            tickets.append((eng.submit(req, workload=wid, priority=i % 2), wid, i))
    eng.flush()
    return {(w, i): np.asarray(eng.result(t)) for t, w, i in tickets}


def test_mixed_engine_counts_match_reference():
    _needs_reference()
    ref_eng, port_eng = _mixed_engines(features=False)
    want, got = _serve_mixed(ref_eng), _serve_mixed(port_eng)
    for key in want:
        # Count-only results keep exact int32 counts (the reference: float32).
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    assert got[(2, 0)].shape == (2, 2, 2, 8, 8)
    ref_st, port_st = ref_eng.stats(), port_eng.stats()
    for wid in range(4):
        for k in ("served", "batches", "batch_occupancy", "buckets"):
            assert port_st["workloads"][wid][k] == ref_st["workloads"][wid][k]


def test_mixed_engine_features_match_reference_formulas():
    _needs_reference()
    ref_counts = _serve_mixed(_mixed_engines(features=False)[0])
    port_feats = _serve_mixed(_mixed_engines(features=True)[1])
    for key, counts in ref_counts.items():
        want = reference_features(counts)
        got = port_feats[key]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL,
                                   err_msg=str(key))
        np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL,
                                   err_msg=str(key))


def _dtype_request(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(SHAPE) < 0.4
    if np.issubdtype(dtype, np.floating):
        return (rng.random(SHAPE) * 255.0 - 40.0).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -300), min(info.max, 3000), SHAPE,
                        endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.uint16, np.uint32, np.uint64,
                                   np.int8, np.int16, np.int32, np.int64, np.float16,
                                   np.float32, np.float64, np.dtype(">u2"), np.dtype(">f4")],
                         ids=lambda d: np.dtype(d).name + ("_be" if np.dtype(d).byteorder == ">"
                                                           else ""))
def test_request_dtypes_match_reference(dtype):
    """Every admitted dtype, big-endian ones too, alone and padded in a
    bucket: the reference's counts, for fused uniform, equalized and
    raw-level (unquantized) specs."""
    _needs_reference()
    reqs = [_dtype_request(dtype, s) for s in range(3)]
    for spec in (dict(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform"),
                 dict(levels=8, pairs=((1, 0),), quantize="equalized"),
                 dict(levels=8, pairs=((1, 0),), quantize="uniform", vrange=(-40, 215))):
        ref_cfg = RefConfig(spec=RefSpec(**spec), image_shape=SHAPE, batch_size=4,
                            features=False)
        want = RefEngine(ref_cfg).map(reqs)
        got = GLCMEngine(GLCMServeConfig.from_dict(dataclasses.asdict(ref_cfg))).map(reqs)
        np.testing.assert_array_equal(got, want, err_msg=str(spec))
    if dtype in (np.bool_, np.uint8, np.int8):
        raw = dict(levels=256 if dtype != np.bool_ else 2, pairs=((1, 0),), quantize=None,
                   scheme="scatter")
        if dtype == np.int8:
            reqs = [(np.abs(r.astype(np.int16)) % 128).astype(np.int8) for r in reqs]
        ref_cfg = RefConfig(spec=RefSpec(**raw), image_shape=SHAPE, batch_size=4,
                            features=False)
        got = GLCMEngine(GLCMServeConfig.from_dict(dataclasses.asdict(ref_cfg))).map(reqs)
        np.testing.assert_array_equal(got, RefEngine(ref_cfg).map(reqs))


def test_uint64_past_int64_refused():
    eng = GLCMEngine(_cfg())
    bad = np.zeros(SHAPE, np.uint64)
    bad[3, 4] = np.iinfo(np.uint64).max
    with pytest.raises(ValueError, match="int64 range"):
        eng.submit(bad)
    assert eng.stats()["workloads"][0]["submitted"] == 0
    ok = eng.map([np.full(SHAPE, 2 ** 40, np.uint64)])  # wide but exact
    assert ok.shape == (1, 1, 14) and np.isfinite(ok).all()


def test_stream_session_checkpoint_matches_reference_engine():
    """A port session closed after frame ``cut`` and resumed from its
    ``state_dict()`` follows the reference engine's pushes."""
    _needs_reference()
    video = _video()
    spec = dict(levels=S_LEVELS, pairs=S_PAIRS, quantize="uniform", vrange=(0, S_LEVELS))
    ref_cfg = RefConfig(spec=RefSpec(**spec), image_shape=S_SHAPE, batch_size=2,
                        temporal_window=S_WINDOW)
    ref_eng = RefEngine(ref_cfg)
    eng = GLCMEngine(GLCMServeConfig.from_dict(dataclasses.asdict(ref_cfg)))
    ref_sid, sid = ref_eng.open_stream(), eng.open_stream()
    cut = S_WINDOW + 1
    for t, frame in enumerate(video):
        pushed, got = ref_eng.push(ref_sid, frame), eng.push(sid, frame)
        assert got.shape == pushed.shape and got.dtype == np.float32
        # The reference's formulas in float64 on its own window counts...
        want = reference_features(np.asarray(ref_eng._streams[ref_sid].counts))
        np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL,
                                   err_msg=f"frame {t}")
        np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL,
                                   err_msg=f"frame {t}")
        # ...and its float32 push, whose rounding of f3, f9, f12 and f13
        # alone exceeds rtol 1e-5 (3.6e-5 here; ROADMAP Queue 3).
        np.testing.assert_allclose(got, pushed, rtol=1e-4, atol=1e-5, err_msg=f"frame {t}")
        if t == cut:
            sd = eng.close_stream(sid).state_dict()
            np.testing.assert_array_equal(
                sd["counts"], np.asarray(ref_eng._streams[ref_sid].counts))
            sid = eng.open_stream(state=sd)
    assert eng.stats()["frames_streamed"] == S_T


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _event_timed(plan):
    """``chip_smoke.py``'s event-timed plan wrapper around ``plan``: the
    device time of the very plan call the engine makes. The script sits at
    the repo root and runs its phases only from ``main()``."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._EventTimedPlan(plan)


@pytest.mark.cuda
def test_engine_batched_launch_on_card_equals_direct_plan_call():
    _card()
    from repro_torch.kernels.glcm_kernel import glcm_fused, glcm_volume, glcm_vote, glcm_window

    rng = np.random.default_rng(11)
    imgs = (rng.random((6, 64, 64)) * 255).astype(np.uint8)
    vols = rng.random((3, 8, 32, 32), dtype=np.float32)
    eng = _Engine(GLCMServeConfig(spec=GLCMSpec(levels=8, pairs=((1, 0), (1, 45)),
                                                quantize="uniform", vrange=(0, 255)),
                                  image_shape=(64, 64), batch_size=4))
    assert eng.device.type == "cuda" and eng.plan.spec.scheme == "cuda_fused"
    wids = [0,
            eng.register(GLCMSpec(levels=8, pairs=((1, 0),), quantize="equalized"), (64, 64),
                         features=False),
            eng.register(GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform",
                                  region="window", region_shape=16, region_stride=8),
                         (64, 64)),
            eng.register(GLCMSpec(levels=8, pairs=((1, 0), (1, 7)), quantize="uniform",
                                  ndim=3), (8, 32, 32), batch_size=2)]
    kernels = (glcm_fused, glcm_vote, glcm_window, glcm_volume)
    eng.warmup()
    for k in kernels:
        k.launches = 0
    reqs = {0: imgs, 1: imgs, 2: imgs.astype(np.float32), 3: vols}
    tickets = [(eng.submit(r, workload=w), w, i) for w in wids for i, r in enumerate(reqs[w])]
    eng.flush()
    st = eng.stats()["workloads"]
    for w, k in zip(wids, kernels):
        assert k.launches == st[w]["batches"], k.__name__
    for t, w, i in tickets:
        got = eng.result(t)
        assert isinstance(got, np.ndarray)
        b = 4 if w != 3 else 2
        start = i - i % b
        batch = list(reqs[w][start:start + b])
        bucket = pick_bucket(eng._workloads[w].buckets, len(batch))
        stack, _ = pad_stack(batch, bucket)
        want = eng._plan_for(eng._workloads[w], bucket)(torch.from_numpy(stack).cuda())
        np.testing.assert_array_equal(got, want[i - start].cpu().numpy())


@pytest.mark.cuda
def test_engine_launch_ms_covers_device_time():
    """The launch phase ends in a device sync: its host time is at least the
    CUDA-event time of the same plan call on the same stack."""
    _card()
    rng = np.random.default_rng(12)
    spec = GLCMSpec(levels=32, pairs=((1, 0), (1, 45), (4, 0), (4, 45)), quantize="uniform",
                    region="window", region_shape=32, region_stride=16)
    eng = _Engine(GLCMServeConfig(spec=spec, image_shape=(512, 512), batch_size=4))
    eng.warmup()
    w = eng._workloads[0]
    timed = _event_timed(eng._plan_for(w, 4))
    w.plans[4] = timed
    for _ in range(3):
        eng.map(rng.random((4, 512, 512), dtype=np.float32))
    assert len(timed.events) == 3
    for launch_ms, event_ms in zip(w.launch_ms, timed.ms()):
        assert launch_ms >= event_ms > 0.0
