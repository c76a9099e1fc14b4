"""The port's counterparts of ``tests/test_train_substrate.py``: optimizers,
checkpointing, fault tolerance, the data pipeline and the train loop, each
through the port's API on the CPU. Two differ on purpose: the watchdog runs
on a fake clock instead of sleeping, and the loop test is the port's
``train`` on the same tiny smollm config (30 steps, then resume to 35)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    DeterministicSkipSampler,
    StepWatchdog,
    resume_or_init,
)
from repro_torch.train.optimizer import (  # noqa: E402
    AdafactorConfig,
    AdamWConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)

CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------


def _quad_params(rng):
    return {"w": _t(rng.normal(size=(4, 8))), "b": _t(rng.normal(size=(8,)))}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_minimize_quadratic(rng, opt):
    params = _quad_params(rng)

    def loss(p):
        return sum(torch.sum(a ** 2) for a in p.values())

    if opt == "adamw":
        ocfg, state, update = AdamWConfig(lr=0.05, weight_decay=0.0), adamw_init(params), \
            adamw_update
    else:
        ocfg, state, update = AdafactorConfig(lr=0.05), adafactor_init(params), adafactor_update

    l0 = float(loss(params))
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
        params, state, _ = update(ocfg, grads, state, params)
    assert float(loss(params)) < 0.2 * l0


def test_adamw_matches_manual_numpy(rng):
    """One AdamW step against a hand-computed update."""
    p = {"w": _t(rng.normal(size=(3, 3)))}
    g = {"w": _t(rng.normal(size=(3, 3)))}
    w0 = p["w"].numpy().astype(np.float64)
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, max_grad_norm=1e9)
    new_p, _, _ = adamw_update(cfg, g, adamw_init(p), p)
    gn = g["w"].numpy().astype(np.float64)
    m = 0.1 * gn
    v = 0.05 * gn * gn
    want = w0 - 0.1 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)


def test_adafactor_memory_is_factored():
    p = {"w": torch.zeros((128, 256)), "b": torch.zeros((256,))}
    st = adafactor_init(p)
    assert tuple(st["v"]["w"]["vr"].shape) == (128,)
    assert tuple(st["v"]["w"]["vc"].shape) == (256,)
    assert tuple(st["v"]["b"]["v"].shape) == (256,)


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(1000.0), rtol=1e-5)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0, rtol=1e-5)


def test_cosine_schedule():
    lr = cosine_schedule(1.0, warmup=10, total=100, final_frac=0.1)
    assert float(lr(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(lr(torch.tensor(10))), 1.0, rtol=1e-5)
    assert float(lr(torch.tensor(100))) <= 0.11
    assert float(lr(torch.tensor(55))) < 1.0


# --------------------------------------------------------------------------
# Checkpointing
# --------------------------------------------------------------------------


def _state(rng):
    return {"params": {"w": _t(rng.normal(size=(4, 4)))},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": [torch.ones((2,)), torch.zeros((3,))]}}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten_with_paths(tree)]


def test_checkpoint_roundtrip(tmp_path, rng):
    st = _state(rng)
    ckpt.save(tmp_path, 100, st, extra={"arch": "test"})
    step, back = ckpt.restore(tmp_path, device=CPU)
    assert step == 100
    for a, b in zip(_leaves(st), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path, rng):
    st = _state(rng)
    for s in (10, 20, 30):
        ckpt.save(tmp_path, s, st)
    assert ckpt.latest_step(tmp_path) == 30
    step, _ = ckpt.restore(tmp_path, 20, device=CPU)
    assert step == 20


def test_torn_checkpoint_ignored(tmp_path, rng):
    ckpt.save(tmp_path, 10, _state(rng))
    torn = tmp_path / "step_000000020"   # a directory without COMMIT
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 10


def test_structure_validation(tmp_path, rng):
    st = _state(rng)
    ckpt.save(tmp_path, 5, st)
    bad = {"params": {"DIFFERENT": st["params"]["w"]}, "opt": st["opt"]}
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, 5, target=bad, device=CPU)


def test_async_checkpointer(tmp_path, rng):
    st = _state(rng)
    w = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        w.save(s, st)
    w.wait()
    assert ckpt.latest_step(tmp_path) == 4
    assert len(sorted(tmp_path.glob("step_*.COMMIT"))) == 2  # GC kept the last two


def test_resume_or_init(tmp_path, rng):
    step, st = resume_or_init(tmp_path, lambda: _state(rng), device=CPU)
    assert step == 0
    ckpt.save(tmp_path, 42, st)
    step2, _ = resume_or_init(tmp_path, lambda: _state(rng), device=CPU)
    assert step2 == 42


# --------------------------------------------------------------------------
# Fault tolerance utilities
# --------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def test_watchdog_flags_straggler():
    events = []
    clock = FakeClock()
    wd = StepWatchdog(threshold=3.0, warmup=0, clock=clock,
                      on_straggler=lambda s, dt, med: events.append((s, dt, med)))
    for i in range(10):
        wd.start()
        clock.now += 0.002
        wd.stop(i)
    wd.start()
    clock.now += 0.05  # 25x median
    assert wd.stop(99) == pytest.approx(0.05)
    assert 99 in wd.stragglers and [e[0] for e in events] == [99]
    assert events[0][2] == pytest.approx(0.002)


def test_deterministic_skip_sampler():
    s = DeterministicSkipSampler(7, lambda rng: rng.integers(0, 100, 5))
    a, b, c = s.batch_at(123), s.batch_at(123), s.batch_at(124)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_synthetic_tokens_deterministic_and_seekable():
    from repro_torch.data.tokens import SyntheticTokens

    ds = SyntheticTokens(1000, seq_len=16, global_batch=4, seed=3)
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    sliced = ds.batch_at(5, host_slice=slice(1, 3))
    np.testing.assert_array_equal(sliced["tokens"], b1["tokens"][1:3])
    assert b1["tokens"].max() < 1000


# --------------------------------------------------------------------------
# End-to-end micro training: loss decreases + resume
# --------------------------------------------------------------------------


def test_train_loop_learns_and_resumes(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.train.loop import TrainLoopConfig, train

    cfg = get_config("smollm-135m").reduced(num_layers=1, d_model=32, num_heads=2,
                                            num_kv_heads=1, head_dim=16, d_ff=64,
                                            vocab_size=512)
    out = train(cfg, TrainLoopConfig(total_steps=30, log_every=5, ckpt_every=20,
                                     ckpt_dir=str(tmp_path)), device=CPU)
    hist = out["history"]
    assert hist[-1]["loss"] < hist[0]["loss"], "loss did not decrease"
    # resume from the step-20 checkpoint and continue to 35
    out2 = train(cfg, TrainLoopConfig(total_steps=35, log_every=5, ckpt_every=100,
                                      ckpt_dir=str(tmp_path)), device=CPU)
    assert out2["history"][0]["step"] >= 21
