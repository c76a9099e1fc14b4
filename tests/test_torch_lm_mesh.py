"""The LM sharded on a device mesh (``train.loop.train(mesh=)``, the
``sharding`` package on DTensor) against the reference, on the CPU.

One spawned world of 4 gloo ranks (``python -c`` children on a ``FileStore``
under ``tmp_path``, one thread each, ``device="cpu"``; the parent kills them
after CHILD_TIMEOUT_S) runs every sharded case on a (2, 2) ("data",
"model") mesh; the parent holds what rank 0 saved against the reference:

* reduced smollm-135m (remat on, chunked attention), olmo-1b (fsdp
  parameters) and whisper-medium (encoder-decoder; its configured context
  layout and the heads_tp layout): the sharded loss and every gradient
  against ``jax.value_and_grad`` of the reference's loss, and the update of
  those gradients on the mesh (the optimizer, as the port's
  ``make_train_step`` runs it) against the reference's jitted
  ``make_train_step`` on one device, from the reference's parameters
  (carried over by ``models.convert``), float32 on a seeded batch of 4 x 16.
  Tolerances: the loss within 1e-6 relative; each gradient within 1e-5 of
  its max |g| plus 1e-6 of the model's (``test_torch_train_grads.py``'s);
  the parameters after the step within 1e-6 where the gradient exceeds its
  tolerance, and within 2 · lr + 1e-6 elsewhere (AdamW's first update is
  about lr · sign(g), and a gradient that is float32 noise around zero can
  change sign when the ranks sum it in another order);
* ``train(mesh=)`` of reduced smollm-135m for 3 steps with a checkpoint at
  step 2 against ``train`` on one process (losses within 1e-5 relative, the
  parameters within 1e-6 and 2 · lr as above); the checkpoint restored onto
  a (4, 1) mesh by ``restore(shardings=)`` and onto one process, and
  re-placed onto (1, 4) by ``reshard_tree``, every leaf bit for bit the
  saved array, and one further step on each giving the loss of one process
  resumed from it (within 1e-5);
* ``reshard_tree`` scale-down and scale-up as ``test_elastic_remesh.py``:
  a state placed on (2, 2) by P("data", "model"), saved, restored onto
  (4, 1) by the same spec and onto (1, 4) by P(None, "model"), bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten_paths, params_from_reference  # noqa: E402
from repro_torch.models.transformer import shard_friendly_xent  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402

try:  # the reference needs JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import build_model as jbuild
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CHILD_TIMEOUT_S = 240
WORLD = 4
B, T, TOTAL = 4, 16, 20
LOSS_RTOL, LEAF_RTOL, MODEL_RTOL, PARAM_ATOL, LOOP_RTOL = 1e-6, 1e-5, 1e-6, 1e-6, 1e-5
# name: (arch, config overrides, the loss's chunk)
CASES = {
    "smollm-135m": ("smollm-135m", {"remat": True}, 8),
    "olmo-1b": ("olmo-1b", {}, 1024),
    "whisper-medium": ("whisper-medium", {}, 1024),
    "whisper-medium-heads_tp": ("whisper-medium", {"attn_layout": "heads_tp"}, 1024),
    "mamba2-130m": ("mamba2-130m", {}, 1024),
    "hymba-1.5b": ("hymba-1.5b", {}, 1024),
    "mixtral-8x7b": ("mixtral-8x7b", {}, 1024),
    "arctic-480b": ("arctic-480b", {}, 1024),
}
LOOP = dict(total_steps=3, log_every=1, ckpt_every=2, seq_len=16, global_batch=4)


def _cfg(name):
    arch, over, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.embeds_input:
        key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
        batch[key] = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    return batch


# One rank. argv: rank, FileStore path, work directory.
RANK_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, store, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import (
        load_reference_params, load_reference_tree, nest_paths)
    from repro_torch.models.model import model_module
    from repro_torch.sharding.partition import P, named
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import reshard_tree
    from repro_torch.train.loop import (
        TrainLoopConfig, on_mesh, shard_batch, shard_params, state_shardings, train)
    from repro_torch.train.optimizer import make_optimizer

    CPU = torch.device("cpu")
    mesh = make_host_mesh((2, 2), ("data", "model"))
    out, meta = {}, {}

    def save(key, t):
        out[key] = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()

    def load(name):
        with np.load(os.path.join(work, name + ".npz")) as z:
            return {k.replace("|", "/"): z[k] for k in z.files}

    for name, (arch, over, chunk) in CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        params = nest_paths(load(name + ".params"))
        batch = load(name + ".batch")
        api = build_model(cfg, device=CPU)
        model = shard_params(cfg, load_reference_params(model_module(cfg, device=CPU), params),
                             mesh)
        with on_mesh(cfg, mesh):
            loss, _ = api.loss(model, shard_batch(cfg, batch, mesh, CPU), chunk=chunk)
            loss.backward()
        save(f"{name}/loss", loss)
        for n, p in model.named_parameters():
            save(f"{name}/grad/{n}", p.grad)
        # The step's update from these gradients, as make_train_step runs it.
        ocfg, oinit, oupdate = make_optimizer(cfg.optimizer, total_steps=TOTAL)
        opt = reshard_tree(oinit(model), state_shardings(cfg, oinit, mesh)["opt"])
        with on_mesh(cfg, mesh):
            _, _, m = oupdate(ocfg, None, opt, model)
        save(f"{name}/step/lr", m["lr"])
        for n, p in model.named_parameters():
            save(f"{name}/step/param/{n}", p)

    # train(mesh=) with a checkpoint, then the elastic cases.
    cfg = get_config("smollm-135m").reduced()
    d = os.path.join(work, "ckpt")
    hist = []
    res = train(cfg, TrainLoopConfig(ckpt_dir=d, **LOOP), mesh=mesh, device=CPU,
                log_fn=lambda s, m: hist.append(m["loss"]))
    meta["losses"] = hist
    for n, p in res["params"].named_parameters():
        save(f"loop/param/{n}", p)
    tokens = shard_batch(cfg, {"tokens": np.zeros((4, 16), np.int32)}, mesh, CPU)["tokens"]
    embed = res["params"].embeddings.embed
    meta["local"] = {"embed": list(embed.to_local().shape), "tokens": list(tokens.to_local().shape),
                     "placements": [str(p) for p in embed.placements]}
    oinit = make_optimizer(cfg.optimizer, total_steps=LOOP["total_steps"])[1]
    mesh41 = make_host_mesh((4, 1), ("data", "model"))
    mesh14 = make_host_mesh((1, 4), ("data", "model"))
    _, state41 = ckpt.restore(d, 2, shardings=state_shardings(cfg, oinit, mesh41))
    state14 = reshard_tree(state41, state_shardings(cfg, oinit, mesh14))
    for tag, st in (("41", state41), ("14", state14)):
        for path, leaf in ckpt._flatten_with_paths(st):
            save(f"elastic/{tag}{path}", leaf)
    h41 = []
    train(cfg, TrainLoopConfig(ckpt_dir=d, **{**LOOP, "total_steps": 4}), mesh=mesh41,
          device=CPU, log_fn=lambda s, m: h41.append((s, m["loss"])))
    meta["loss41"] = h41
    model = shard_params(cfg, model_module(cfg, device=CPU), mesh14)
    load_reference_tree(model, state14["params"])
    step, _ = make_train_step(cfg, total_steps=4, device=CPU)
    from repro_torch.data.tokens import SyntheticTokens
    b3 = SyntheticTokens(cfg.vocab_size, seq_len=16, global_batch=4, seed=0).batch_at(3)
    with on_mesh(cfg, mesh14):
        _, _, m = step(model, state14["opt"], shard_batch(cfg, b3, mesh14, CPU))
    meta["loss14"] = float(m["loss"].full_tensor())

    # reshard_tree as test_elastic_remesh.py.
    state = nest_paths(load("remesh"))
    placed = reshard_tree(state, named(mesh, {"params": {"w": P("data", "model")},
                                              "opt": {"mu": P("data", "model")}}))
    ckpt.save(os.path.join(work, "remesh_ckpt"), 7, placed)
    for tag, m_, spec in (("41", mesh41, P("data", "model")), ("14", mesh14, P(None, "model"))):
        sh = named(m_, {"params": {"w": spec}, "opt": {"mu": spec}})
        step_, back = ckpt.restore(os.path.join(work, "remesh_ckpt"), shardings=sh)
        meta[f"remesh{tag}"] = {"step": step_, "local": list(back["params"]["w"].to_local().shape)}
        for path, leaf in ckpt._flatten_with_paths(back):
            save(f"remesh/{tag}{path}", leaf)

    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"), **{k.replace("/", "|"): v for k, v in out.items()})
        meta["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(work, "rank0.json"), "w") as f:
            json.dump(meta, f)
    dist.destroy_process_group()
    """
).replace("WORLD", str(WORLD)).replace("CASES", repr(CASES)).replace(
    "LOOP", repr(LOOP)).replace("TOTAL", str(TOTAL))


def _savez(path: Path, flat: dict) -> None:
    np.savez(path, **{k.replace("/", "|"): np.asarray(v) for k, v in flat.items()})


class Saved:
    def __init__(self, work: Path):
        with np.load(work / "rank0.npz") as z:
            self.arr = {k.replace("|", "/"): z[k] for k in z.files}
        self.meta = json.loads((work / "rank0.json").read_text())
        self.work = work

    def tree(self, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in self.arr.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's parameters, batches and results for every case, and
    the 4-rank world's results."""
    if jax is None:
        pytest.skip("the reference package needs JAX")
    work = tmp_path_factory.mktemp("lm_mesh")
    refs = {}
    for name, (arch, over, chunk) in CASES.items():
        jcfg = dataclasses.replace(jget(arch).reduced(), **over)
        japi = jbuild(jcfg)
        params = japi.init(jax.random.key(0))
        batch = _batch(_cfg(name), seed=len(name))
        _savez(work / f"{name}.params.npz", dict(flatten_paths(jax.tree.map(np.asarray, params))))
        _savez(work / f"{name}.batch.npz", batch)
        refs[name] = (jcfg, japi, params, batch, chunk)
    rng = np.random.default_rng(0)
    _savez(work / "remesh.npz", {"params/w": rng.normal(size=(16, 8)).astype(np.float32),
                                 "opt/mu": rng.normal(size=(16, 8)).astype(np.float32)})
    store = work / "world.store"
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(WORLD):
        log = open(work / f"r{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(store),
                                        str(work)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    try:
        want = {}   # the reference's results, while the ranks run
        for name, (jcfg, japi, params, batch, chunk) in refs.items():
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, b: japi.loss(p, b, chunk=chunk), has_aux=True))(params, jb)
            jstep, jinit = jmake_train_step(jcfg, total_steps=TOTAL)
            new, _, metrics = jax.jit(jstep)(params, jinit(params), jb)
            want[name] = {"loss": float(loss),
                          "grads": params_from_reference(_cfg(name), jax.tree.map(np.asarray, g)),
                          "step_loss": float(metrics["loss"]),
                          "params": params_from_reference(_cfg(name),
                                                          jax.tree.map(np.asarray, new))}
        for p, _ in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        for p, _ in procs:
            p.wait()
        pytest.fail(f"a rank did not finish in {CHILD_TIMEOUT_S} s (deadlock?)")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        for _, log in procs:
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (work / f"r{r}.log").read_text()[-4000:]
    return Saved(work), want


def _assert_grads(got: dict, want: dict, what: str) -> dict:
    """The gradient tolerances of ``test_torch_train_grads.py``; returns each
    parameter's tolerance."""
    assert set(got) == set(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    tols = {}
    for n, w in want.items():
        tols[n] = LEAF_RTOL * float(np.abs(w).max()) + MODEL_RTOL * top
        d = float(np.abs(got[n] - np.asarray(w)).max())
        assert d <= tols[n], f"{what} {n}: max |Δ| {d} > {tols[n]}"
    return tols


def _assert_adamw_params(got: dict, want: dict, grads: dict, tols: dict, lr: float, what: str):
    """After one AdamW step: within PARAM_ATOL where the gradient exceeds its
    tolerance, within 2 · lr + PARAM_ATOL elsewhere."""
    assert set(got) == set(want), what
    for n, w in want.items():
        d = np.abs(got[n] - np.asarray(w))
        sure = np.abs(np.asarray(grads[n])) > tols[n]
        assert float(d[sure].max(initial=0.0)) <= PARAM_ATOL, f"{what} {n}"
        assert float(d[~sure].max(initial=0.0)) <= 2 * lr + PARAM_ATOL, f"{what} {n}"


def test_ranks_import_neither_jax_nor_the_reference(world):
    saved, _ = world
    assert saved.meta["modules"] == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_and_grads_match_reference(world, name):
    saved, want = world
    w = want[name]
    loss = float(saved.arr[f"{name}/loss"])
    assert abs(loss - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (loss, w["loss"])
    _assert_grads(saved.tree(f"{name}/grad/"), {k: v.numpy() for k, v in w["grads"].items()},
                  name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_reference(world, name):
    saved, want = world
    w = want[name]
    loss = float(saved.arr[f"{name}/loss"])   # the step's loss: the default chunk there
    assert abs(loss - w["step_loss"]) <= LOSS_RTOL * abs(w["step_loss"])
    grads = {k: v.numpy() for k, v in w["grads"].items()}
    top = max(float(np.abs(g).max()) for g in grads.values())
    tols = {n: LEAF_RTOL * float(np.abs(g).max()) + MODEL_RTOL * top for n, g in grads.items()}
    _assert_adamw_params(saved.tree(f"{name}/step/param/"),
                         {k: v.numpy() for k, v in w["params"].items()}, grads, tols,
                         float(saved.arr[f"{name}/step/lr"]), name)


def _one_process(total_steps: int, ckpt_dir=None) -> tuple[list[float], torch.nn.Module]:
    hist = []
    out = train(get_config("smollm-135m").reduced(),
                TrainLoopConfig(**{**LOOP, "total_steps": total_steps}, ckpt_dir=ckpt_dir),
                device="cpu", log_fn=lambda s, m: hist.append(m["loss"]))
    return hist, out["params"]


def test_train_on_mesh_matches_one_process(world):
    saved, _ = world
    want, model = _one_process(LOOP["total_steps"])
    got = saved.meta["losses"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOOP_RTOL * abs(w), (got, want)
    params = saved.tree("loop/param/")
    for n, p in model.named_parameters():   # 3 AdamW steps of lr <= 3e-4 each
        assert np.abs(params[n] - p.detach().numpy()).max() <= 3 * 2 * 3e-4 + PARAM_ATOL, n
    # The vocab (embedding rows) over "model", the batch over "data" and the
    # sequence over "model".
    cfg = get_config("smollm-135m").reduced()
    assert saved.meta["local"] == {"embed": [cfg.padded_vocab // 2, cfg.d_model],
                                   "tokens": [2, 8], "placements": ["R", "S(0)"]}


def test_checkpoint_restores_onto_other_meshes_bit_for_bit(world):
    saved, _ = world
    d = saved.work / "ckpt"
    assert ckpt.latest_step(d) == 2
    _, back = ckpt.restore(d, 2, device="cpu")   # onto one process
    flat = {p: leaf.numpy() for p, leaf in ckpt._flatten_with_paths(back)}
    for tag in ("41", "14"):
        got = saved.tree(f"elastic/{tag}")
        assert set(got) == set(flat), tag
        for p, arr in flat.items():
            assert got[p].dtype == arr.dtype and np.array_equal(got[p], arr), (tag, p)
    # One further step from the checkpoint on (4, 1) (train resumes), on
    # (1, 4) (the re-placed state) and on one process (train resumes): the
    # same loss.
    resumed, _ = _one_process(4, ckpt_dir=str(d))
    assert saved.meta["loss41"][0][0] == 3 and len(resumed) == 1
    for loss in (saved.meta["loss41"][0][1], saved.meta["loss14"]):
        assert abs(loss - resumed[0]) <= LOOP_RTOL * abs(resumed[0]), (loss, resumed[0])


def test_reshard_tree_scale_down_and_up(world):
    saved, _ = world
    with np.load(saved.work / "remesh.npz") as z:
        want = {"/" + k.replace("|", "/"): z[k] for k in z.files}
    for tag, local in (("41", [4, 8]), ("14", [16, 2])):
        assert saved.meta[f"remesh{tag}"] == {"step": 7, "local": local}
        got = saved.tree(f"remesh/{tag}")
        assert set(got) == set(want)
        for p, arr in want.items():
            assert np.array_equal(got[p], arr), (tag, p)


def test_shard_friendly_xent_equals_gather_bit_for_bit():
    """The iota-compare-select gold logit (the reference's form) against the
    gather the port took before: one logit and zeros sum exactly."""
    g = torch.Generator().manual_seed(0)
    for shape in ((2, 7, 50), (3, 1, 128), (1, 33, 49152)):
        lg = torch.randn(shape, generator=g) * 30
        lg[..., -3:] = -1e9   # padded vocab rows
        targets = torch.randint(0, shape[-1] - 3, shape[:-1], generator=g, dtype=torch.int32)
        gather = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, targets[..., None].long())[..., 0]
                  ).mean()
        assert torch.equal(shard_friendly_xent(lg, targets), gather)
    cfg = get_config("smollm-135m").reduced()
    api = build_model(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(1))
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))}
    logits, _ = api.forward(model, batch)
    lg = logits[:, :-1].float()
    tg = torch.as_tensor(batch["tokens"][:, 1:])
    want = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, tg[..., None])[..., 0]).mean()
    assert torch.equal(api.loss(model, batch)[1]["nll"], want)
