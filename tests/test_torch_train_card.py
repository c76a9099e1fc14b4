"""Training on the card against the CPU at reduced size (``cuda`` tests:
they skip where there is no card, and need no JAX, so they run on the
card's machine).

Float32 compute and the same initial weights on both sides, TF32 off (the
default): three ``make_train_step`` steps on the card against the CPU. The
loss, ``grad_norm`` and ``lr`` of each step within CARD_RTOL = 1e-5 /
CARD_ATOL = 1e-6. Parameters and optimizer state within CARD_RTOL /
CARD_ATOL, except where AdamW amplifies summation-order noise: its update is
about lr · sign(g), so an element whose gradient lies within float32 noise
of zero can move apart by up to 2 · lr a step. Such elements may be at most
CARD_APART = 1e-4 of the parameters, each within 2 · Σ lr. The loop trains
and resumes on the card; an ``AsyncCheckpointer`` save followed at once by
an in-place step on the card writes the pre-step values.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402

CARD_RTOL, CARD_ATOL = 1e-5, 1e-6
CARD_APART = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: training on the card against the CPU")


def _flat(tree, prefix=""):
    return dict(ckpt._flatten_with_paths(tree, prefix))


def _close(got, want, what):
    torch.testing.assert_close(got.cpu(), want, rtol=CARD_RTOL, atol=CARD_ATOL, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,accum", [("smollm-135m", 1), ("mixtral-8x7b", 1),
                                        ("smollm-135m", 2)])
def test_card_steps_equal_cpu(arch, accum):
    _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch).reduced(), grad_accum=accum)
    m_cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m_card = model_module(cfg, device="cuda")
    m_card.load_state_dict(m_cpu.state_dict())
    s_cpu, i_cpu = make_train_step(cfg, total_steps=20, device="cpu")
    s_card, i_card = make_train_step(cfg, total_steps=20, device="cuda")
    o_cpu, o_card = i_cpu(m_cpu), i_card(m_card)
    ds = SyntheticTokens(cfg.vocab_size, seq_len=32, global_batch=2, seed=1)
    lr_sum = 0.0
    for k in range(3):
        batch = ds.batch_at(k)
        m_cpu, o_cpu, want = s_cpu(m_cpu, o_cpu, batch)
        m_card, o_card, got = s_card(m_card, o_card, batch)
        for key in want:
            _close(got[key], want[key], f"step {k} {key}")
        lr_sum += float(want["lr"])
    pairs = [(n, p.detach().cpu(), q.detach())
             for (n, p), (_, q) in zip(m_card.named_parameters(), m_cpu.named_parameters())]
    card, cpu = _flat(o_card), _flat(o_cpu)
    pairs += [(k, card[k].cpu(), cpu[k]) for k in cpu if cpu[k].is_floating_point()]
    apart = total = 0
    for name, g, w in pairs:
        d = (g - w).abs()
        far = d > CARD_ATOL + CARD_RTOL * w.abs()
        apart += int(far.sum())
        total += w.numel()
        if cfg.optimizer == "adafactor":   # smooth in g: no sign amplification
            assert not bool(far.any()), f"{name}: max |Δ| {float(d.max())}"
        elif not name.startswith("/"):     # a parameter (not a moment)
            assert float(d.max()) <= 2 * lr_sum + CARD_ATOL, f"{name}: {float(d.max())}"
    assert apart <= CARD_APART * total, f"{apart} of {total} elements apart"
    assert int(card["/step"]) == int(cpu["/step"]) == 3


@pytest.mark.cuda
def test_card_loop_learns_and_resumes(tmp_path):
    _card()
    cfg = get_config("smollm-135m").reduced(num_layers=1, d_model=32, num_heads=2,
                                            num_kv_heads=1, head_dim=16, d_ff=64,
                                            vocab_size=512)
    out = train(cfg, TrainLoopConfig(total_steps=30, log_every=5, ckpt_every=20,
                                     ckpt_dir=str(tmp_path)))
    assert next(out["params"].parameters()).device.type == "cuda"
    hist = out["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    out2 = train(cfg, TrainLoopConfig(total_steps=35, log_every=5, ckpt_every=100,
                                      ckpt_dir=str(tmp_path)))
    assert out2["history"][0]["step"] >= 21   # resumed from the step-20 checkpoint


@pytest.mark.cuda
def test_card_async_save_writes_pre_step_values(tmp_path):
    _card()
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
    step, init = make_train_step(cfg, total_steps=10, device="cuda")
    opt = init(model)
    batch = SyntheticTokens(cfg.vocab_size, seq_len=32, global_batch=2).batch_at(0)
    model, opt, _ = step(model, opt, batch)
    live = {"params": dict(model.named_parameters()), "opt": opt}
    before = {k: v.detach().cpu().clone() for k, v in _flat(live).items()}
    writer = ckpt.AsyncCheckpointer(tmp_path)
    writer.save(1, live)
    model, opt, _ = step(model, opt, batch)    # in place, queued at once
    writer.wait()
    _, back = ckpt.restore(tmp_path, 1, device="cpu")
    got = _flat(back)
    for k, v in before.items():
        assert torch.equal(got[k], v), k
