"""Checkpoints across the two packages, the asynchronous writer against an
in-place step, preemption, and the training CLI, on the CPU.

A directory written by the reference's ``save`` restores in the port (and
loads into a model through ``load_reference_tree``), and the reverse; a
bfloat16 leaf crosses as its bits. ``AsyncCheckpointer.save`` followed at
once by an in-place step writes the pre-step values.
"""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    load_reference_tree,
    params_from_reference,
    reference_tree,
)
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _model(arch="smollm-135m", seed=0):
    cfg = get_config(arch).reduced()
    return cfg, build_model(cfg, device=CPU).init(torch.Generator().manual_seed(seed))


def _flat(tree, prefix=""):
    return dict(ckpt._flatten_with_paths(tree, prefix))


def test_reference_checkpoint_restores_in_port(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import adafactor_init

    jcfg = jget("mixtral-8x7b").reduced()
    params = jbuild(jcfg).init(jax.random.key(0))
    tree = {"params": params, "opt": adafactor_init(params)}
    jckpt.save(tmp_path, 7, tree, extra={"arch": jcfg.name})
    step, back = ckpt.restore(tmp_path, device=CPU)
    assert step == 7
    want = _flat(jax.tree.map(np.asarray, tree))
    got = _flat(back)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        assert got[k].numpy().dtype == w.dtype, k
    cfg = get_config("mixtral-8x7b").reduced()
    model = load_reference_tree(model_module(cfg, device=CPU), back["params"])
    sd = params_from_reference(cfg, jax.tree.map(np.asarray, params))
    for n, p in model.named_parameters():
        assert torch.equal(p, sd[n]), n


def test_port_checkpoint_restores_in_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.train import checkpoint as jckpt

    cfg, model = _model()
    tree = {"params": reference_tree(model), "opt": adamw_init(model),
            "bf16": torch.linspace(-3, 3, 7).to(torch.bfloat16)}
    ckpt.save(tmp_path, 3, tree)
    step, back = jckpt.restore(tmp_path)
    assert step == 3
    got, want = _flat(back), _flat(tree)
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == torch.bfloat16:   # the bits, as models.convert reads them
            np.testing.assert_array_equal(np.asarray(got[k]).view(np.int16),
                                          w.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), w.numpy(), err_msg=k)
    # ...and back into the port, bfloat16 included.
    _, again = ckpt.restore(tmp_path, device=CPU)
    assert again["bf16"].dtype == torch.bfloat16 and torch.equal(again["bf16"], tree["bf16"])
    sd = params_from_reference(cfg, _nested_numpy(back["params"]))
    for n, p in model.named_parameters():
        assert torch.equal(p, sd[n]), n


def _nested_numpy(tree):
    return {k: _nested_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_async_save_then_in_place_step_writes_pre_step_values(tmp_path):
    """The writer copies to host memory before ``save`` returns: a train
    step that updates the parameters and the optimizer state in place right
    after it leaves the checkpoint at the pre-step values."""
    cfg, model = _model()
    step, init = make_train_step(cfg, total_steps=10, device=CPU)
    opt = init(model)
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32)}
    model, opt, _ = step(model, opt, batch)
    before = {k: v.clone() for k, v in _flat({"params": {n: p for n, p in
                                                          model.named_parameters()},
                                               "opt": opt}).items()}
    writer = ckpt.AsyncCheckpointer(tmp_path)
    # The parameters themselves (no stacked copy) and the live optimizer state.
    writer.save(1, {"params": {n: p for n, p in model.named_parameters()}, "opt": opt})
    model, opt, _ = step(model, opt, batch)
    writer.wait()
    _, back = ckpt.restore(tmp_path, 1, device=CPU)
    got = _flat(back)
    moved = 0
    for k, v in before.items():
        assert torch.equal(got[k], v), k
    for n, p in model.named_parameters():
        moved += not torch.equal(p, before[f"/params/{n}"])
    assert moved > 0   # the step did move the live parameters


def test_preemption_checkpoints_synchronously(tmp_path):
    """SIGTERM during a step: the loop finishes it, checkpoints at that step
    and stops."""
    cfg, _ = _model()

    def log_fn(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    out = train(cfg, TrainLoopConfig(total_steps=10, log_every=1, ckpt_every=100,
                                     ckpt_dir=str(tmp_path), seq_len=16, global_batch=2),
                device=CPU, log_fn=log_fn)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert ckpt.latest_step(tmp_path) == 2
    _, back = ckpt.restore(tmp_path, 2, device=CPU)
    saved = _flat(back["params"])
    for k, v in _flat(reference_tree(out["params"])).items():
        assert torch.equal(saved[k], v), k


def test_mesh_and_shardings_wait_for_item_b(tmp_path):
    """Item B has come: on a one-rank gloo world and a (1, 1) mesh,
    ``train(mesh=)`` trains as one process, ``restore(shardings=)`` and
    ``resume_or_init(shardings=)`` place the saved arrays as DTensors;
    ``grad_accum > 1`` on the mesh trains as one process too."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import P, named
    from repro_torch.train.fault_tolerance import resume_or_init

    cfg, _ = _model()
    loop = TrainLoopConfig(total_steps=2, log_every=1, seq_len=16, global_batch=2)
    want = [h["loss"] for h in train(cfg, loop, device=CPU)["history"]]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        out = train(cfg, loop, mesh=mesh, device=CPU)
        assert [h["loss"] for h in out["history"]] == want
        assert isinstance(out["params"].embeddings.embed, DTensor)
        tree = {"w": torch.arange(6.0).reshape(2, 3), "opt": {"step": torch.tensor(3)}}
        ckpt.save(tmp_path / "ck", 1, tree)
        sh = named(mesh, {"w": P("data", "model"), "opt": {"step": P()}})
        for step, back in (ckpt.restore(tmp_path / "ck", 1, shardings=sh),
                           resume_or_init(tmp_path / "ck", lambda: None, shardings=sh)):
            assert step == 1 and isinstance(back["w"], DTensor)
            assert torch.equal(back["w"].full_tensor(), tree["w"])
            assert int(back["opt"]["step"].full_tensor()) == 3
        moe = get_config("mixtral-8x7b").reduced()
        assert ([h["loss"] for h in train(moe, loop, mesh=mesh, device=CPU)["history"]]
                == [h["loss"] for h in train(moe, loop, device=CPU)["history"]])
        accum = dataclasses.replace(loop, grad_accum=2)   # microbatches on a mesh
        assert ([h["loss"] for h in train(cfg, accum, mesh=mesh, device=CPU)["history"]]
                == [h["loss"] for h in train(cfg, accum, device=CPU)["history"]])
    finally:
        dist.destroy_process_group()


def test_train_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                        "--steps", "5"], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "[train] arch=smollm-135m reduced=True device=cpu" in r.stdout
    assert "[train] done: loss" in r.stdout and "over 2 logged steps" in r.stdout
