"""The LM's cells on a device mesh against one process and the reference, on
the CPU: mesh rows B1 (``grad_accum > 1``) and B3 (prefill and decode).

One spawned world of 4 gloo ranks (``python -c`` children on a ``FileStore``
under ``tmp_path``, one thread each, ``device="cpu"``; the parent kills them
after CHILD_TIMEOUT_S) on a (2, 2) ("data", "model") mesh; the parent holds
what rank 0 saved against the reference (float32, the reference's
parameters carried over by ``models.convert``):

* **B3.** ``launch.steps.build_cell``'s prefill program (16 tokens, batch
  4, a 24-slot cache) and then its decode program for three steps, run by
  ``run_program`` on arguments placed by the cells' ``in_shardings``, for
  reduced smollm-135m, mixtral-8x7b (sliding-window ring caches),
  mamba2-130m (SSM state), hymba-1.5b (meta tokens, ring and SSM caches)
  and whisper-medium (cross-attention caches): the last logits of prefill
  and of each decode step, and every cache after the last step, against
  the reference's ``prefill`` / ``decode_step`` and against the port on one
  process (rtol 1e-4 / atol 1e-4, ``test_torch_lm_models.py``'s; integer
  caches equal). Also mamba2's replicated-batch decode at B = 1 (the
  long_500k layout: batch unsharded, the decode cell's rules without
  "batch"), from one process's prefill.
* **B1.** reduced smollm-135m and mixtral-8x7b (capacity factor 1.0, so
  the microbatches drop tokens: the parent checks that they do) with
  ``grad_accum=2``: the loss and gradients of ``accumulate_grads`` on a
  batch split into microbatches and placed by ``shard_batch(accum=2)``,
  against the reference's microbatch sum (its ``make_train_step``'s scan
  body); the AdamW update of ``make_train_step``'s step against the
  reference's jitted ``make_train_step`` with the same ``grad_accum``
  (``test_torch_lm_mesh.py``'s tolerances: loss 1e-6 relative, gradients
  1e-5 of each leaf's max plus 1e-6 of the model's, parameters within
  1e-6, and within 2 · lr + 1e-6 where the gradient is below its
  tolerance); and ``train(mesh=)`` with ``grad_accum=2`` for two steps
  against ``train`` on one process (losses within 1e-5 relative).
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
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths,
    load_reference_params,
    params_from_reference,
)
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402
from test_torch_lm_mesh import _assert_adamw_params, _assert_grads  # noqa: E402
from test_torch_lm_models import _close_caches, close  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CHILD_TIMEOUT_S = 300
WORLD = 4
B, T, S_CACHE, STEPS = 4, 16, 24, 3
TOL, LOSS_RTOL, LOOP_RTOL, TOTAL, ACCUM = 1e-4, 1e-6, 1e-5, 20, 2
SERVE = {name: {} for name in ("smollm-135m", "mixtral-8x7b", "mamba2-130m", "hymba-1.5b",
                               "whisper-medium")}
ACCUM_CASES = {"smollm-135m": {}, "mixtral-8x7b": {"capacity_factor": 1.0}}
LOOP = dict(total_steps=2, log_every=1, seq_len=16, global_batch=4, grad_accum=ACCUM)


def _cfg(arch, pkg=get_config, **over):
    return dataclasses.replace(pkg(arch).reduced(), **over)


def _batch(cfg, seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, T)).astype(np.int32)}
    if cfg.embeds_input:
        key = "enc_embeds" if cfg.is_encoder_decoder else "embeds"
        batch[key] = rng.normal(size=(b, T, cfg.d_model)).astype(np.float32)
    return batch


def _decode_inputs(cfg, seed: int, b: int = B) -> list:
    rng = np.random.default_rng(seed + 100)
    return [(rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
             np.full((b,), T + s, np.int32)) for s in range(STEPS)]


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
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        accumulate_grads, build_cell, make_train_step, place_args, run_program)
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_reference_params, nest_paths
    from repro_torch.models.model import model_module
    from repro_torch.sharding.partition import distribute
    from repro_torch.train.fault_tolerance import reshard_tree
    from repro_torch.train.loop import (
        TrainLoopConfig, on_mesh, shard_batch, shard_params, state_shardings, train)

    CPU = torch.device("cpu")
    mesh = make_host_mesh((2, 2), ("data", "model"))
    out, meta = {}, {}

    def save(key, t):
        out[key] = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()

    def save_tree(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                save_tree(f"{prefix}/{k}", v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                save_tree(f"{prefix}/{i}", v)
        else:
            save(prefix, tree)

    def load(name):
        with np.load(os.path.join(work, name + ".npz")) as z:
            return {k.replace("|", "/"): z[k] for k in z.files}

    def model_of(cfg, name):
        return load_reference_params(model_module(cfg, device=CPU),
                                     nest_paths(load(name + ".params")))

    def decode(cfg, b, name, placed_model, caches, key):
        dec = build_cell(cfg, ShapeCell("d", "decode", S_CACHE, b), mesh)
        inputs = load(name + ".decode")
        meta[key + "/rules_batch"] = dec.rules["batch"]
        for s in range(STEPS):
            tok = distribute(torch.from_numpy(inputs[f"tok{s}"]), dec.in_shardings[2])
            pos = distribute(torch.from_numpy(inputs[f"pos{s}"]), dec.in_shardings[3])
            logits, caches = run_program(dec, mesh, (placed_model, caches, tok, pos))
            save(f"{key}/decode{s}", logits)
        save_tree(f"{key}/caches", caches)

    # B3: the prefill cell, then the decode cell.
    for name, over in SERVE.items():
        cfg = dataclasses.replace(get_config(name).reduced(), **over)
        batch = {k: torch.from_numpy(v) for k, v in load(name + ".batch").items()}
        pre = build_cell(cfg, ShapeCell("p", "prefill", S_CACHE, BATCH), mesh)
        placed_model, placed_batch = place_args(pre, (model_of(cfg, name), batch))
        last, caches = run_program(pre, mesh, (placed_model, placed_batch))
        save(f"serve/{name}/prefill", last)
        decode(cfg, BATCH, name, placed_model, caches, f"serve/{name}")

    # B3: mamba2's replicated-batch decode at B = 1, from one process's prefill.
    cfg = get_config("mamba2-130m").reduced()
    model = model_of(cfg, "mamba2-130m")
    b1 = {k: torch.from_numpy(v) for k, v in load("mamba2-b1.batch").items()}
    _, caches = build_model(cfg, device=CPU).prefill(model, b1, s_cache=S_CACHE)
    dec = build_cell(cfg, ShapeCell("d", "decode", S_CACHE, 1), mesh)
    placed_model, caches = place_args(dec, (model, caches, b1["tokens"][:, :1],
                                            b1["tokens"][:, 0]))[:2]
    decode(cfg, 1, "mamba2-b1", placed_model, caches, "serve/mamba2-b1")

    # B1: grad_accum on a mesh.
    for name, over in ACCUM_CASES.items():
        cfg = dataclasses.replace(get_config(name).reduced(), grad_accum=ACCUM, **over)
        api = build_model(cfg, device=CPU)
        model = shard_params(cfg, model_of(cfg, name), mesh)
        batch = shard_batch(cfg, load(name + ".batch"), mesh, CPU, accum=ACCUM)
        meta[f"accum/{name}/local"] = list(batch["tokens"].to_local().shape)
        with on_mesh(cfg, mesh):
            loss, grads = accumulate_grads(api, model, batch, ACCUM)
        save(f"accum/{name}/loss", loss)
        for n, g in grads.items():
            save(f"accum/{name}/grad/{n}", g)
        step, oinit = make_train_step(cfg, total_steps=TOTAL, device=CPU)
        opt = reshard_tree(oinit(model), state_shardings(cfg, oinit, mesh)["opt"])
        with on_mesh(cfg, mesh):
            _, _, m = step(model, opt, batch)
        save(f"accum/{name}/step/loss", m["loss"])
        save(f"accum/{name}/step/lr", m["lr"])
        for n, p in model.named_parameters():
            save(f"accum/{name}/step/param/{n}", p)

    hist = []
    train(get_config("smollm-135m").reduced(), TrainLoopConfig(**LOOP), mesh=mesh, device=CPU,
          log_fn=lambda s, m: hist.append(m["loss"]))
    meta["loop"] = hist

    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"), **{k.replace("/", "|"): v for k, v in out.items()})
        meta["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(work, "rank0.json"), "w") as f:
            json.dump(meta, f)
    dist.destroy_process_group()
    """
).replace("WORLD", str(WORLD)).replace("SERVE", repr(SERVE)).replace(
    "ACCUM_CASES", repr(ACCUM_CASES)).replace("LOOP", repr(LOOP)).replace(
    "S_CACHE", str(S_CACHE)).replace("STEPS", str(STEPS)).replace(
    "ACCUM", str(ACCUM)).replace("TOTAL", str(TOTAL)).replace("BATCH", str(B))


def _savez(path: Path, flat: dict) -> None:
    np.savez(path, **{k.replace("/", "|"): np.asarray(v) for k, v in flat.items()})


def _nest(flat: dict):
    """Saved "a/0/k" leaves as nested dicts (lists where keys are digits)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(leaf)

    def listify(n):
        if isinstance(n, dict):
            n = {k: listify(v) for k, v in n.items()}
            if n and all(k.isdigit() for k in n):
                return [n[str(i)] for i in range(len(n))]
        return n
    return listify(tree)


def _reference_serve(name, params, batch, inputs):
    jcfg = _cfg(name, jget, **SERVE.get(name, {}))
    japi = jbuild(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    last, caches = jax.jit(lambda p, bb: japi.prefill(p, bb, s_cache=S_CACHE))(params, jb)
    steps = []
    step = jax.jit(japi.decode_step)
    for tok, pos in inputs:
        logits, caches = step(params, caches, jnp.asarray(tok), jnp.asarray(pos))
        steps.append(np.asarray(logits))
    return np.asarray(last), steps, caches


def _port_serve(name, params, batch, inputs):
    cfg = _cfg(name, **SERVE.get(name, {}))
    api = build_model(cfg, device="cpu")
    model = load_reference_params(api.init(torch.Generator().manual_seed(0)), params)
    last, caches = api.prefill(model, batch, s_cache=S_CACHE)
    steps = []
    for tok, pos in inputs:
        logits, caches = api.decode_step(model, caches, tok, pos)
        steps.append(logits.numpy().copy())
    return last.numpy(), steps, caches


def _reference_accum(name, params, batch):
    """The reference's accumulated loss and gradients (its make_train_step's
    scan body, microbatch by microbatch), and its jitted step."""
    jcfg = _cfg(name, jget, grad_accum=ACCUM, **ACCUM_CASES[name])
    japi = jbuild(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(lambda p, b: japi.loss(p, b), has_aux=True))
    gsum = jax.tree.map(jnp.zeros_like, params)
    lsum = jnp.zeros(())
    for i in range(ACCUM):
        mb = jax.tree.map(lambda x: x.reshape((ACCUM, x.shape[0] // ACCUM) + x.shape[1:])[i], jb)
        (loss, _), g = grad(params, mb)
        gsum = jax.tree.map(lambda a, b_: a + (b_ / ACCUM).astype(a.dtype), gsum, g)
        lsum = lsum + loss / ACCUM
    jstep, jinit = jmake_train_step(jcfg, total_steps=TOTAL)
    new, _, metrics = jax.jit(jstep)(params, jinit(params), jb)
    cfg = _cfg(name, grad_accum=ACCUM, **ACCUM_CASES[name])
    return {"loss": float(lsum), "step_loss": float(metrics["loss"]),
            "grads": params_from_reference(cfg, jax.tree.map(np.asarray, gsum)),
            "params": params_from_reference(cfg, jax.tree.map(np.asarray, new))}


class Saved:
    def __init__(self, work: Path):
        with np.load(work / "rank0.npz") as z:
            self.arr = {k.replace("|", "/"): z[k] for k in z.files}
        self.meta = json.loads((work / "rank0.json").read_text())

    def tree(self, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in self.arr.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs for every case, the 4-rank world's results, and the
    reference's and one process's, computed while the ranks run."""
    work = tmp_path_factory.mktemp("lm_mesh_cells")
    inputs, params = {}, {}
    for i, name in enumerate([*SERVE, *ACCUM_CASES]):
        if name in params:
            continue
        jparams = jbuild(_cfg(name, jget)).init(jax.random.key(0))
        params[name] = jparams
        _savez(work / f"{name}.params.npz", dict(flatten_paths(jax.tree.map(np.asarray,
                                                                           jparams))))
        batch = _batch(_cfg(name), seed=i)
        dec = _decode_inputs(_cfg(name), seed=i)
        inputs[name] = (batch, dec)
        _savez(work / f"{name}.batch.npz", batch)
        _savez(work / f"{name}.decode.npz", {**{f"tok{s}": t for s, (t, _) in enumerate(dec)},
                                             **{f"pos{s}": p for s, (_, p) in enumerate(dec)}})
    b1 = _batch(_cfg("mamba2-130m"), seed=99, b=1)
    dec1 = _decode_inputs(_cfg("mamba2-130m"), seed=99, b=1)
    inputs["mamba2-b1"] = (b1, dec1)
    _savez(work / "mamba2-b1.batch.npz", b1)
    _savez(work / "mamba2-b1.decode.npz", {**{f"tok{s}": t for s, (t, _) in enumerate(dec1)},
                                           **{f"pos{s}": p for s, (_, p) in enumerate(dec1)}})
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
        want = {}
        for name in SERVE:
            np_params = jax.tree.map(np.asarray, params[name])
            batch, dec = inputs[name]
            want[("ref", name)] = _reference_serve(name, params[name], batch, dec)
            want[("one", name)] = _port_serve(name, np_params, batch, dec)
        np_params = jax.tree.map(np.asarray, params["mamba2-130m"])
        want[("ref", "mamba2-b1")] = _reference_serve("mamba2-130m", params["mamba2-130m"],
                                                      b1, dec1)
        want[("one", "mamba2-b1")] = _port_serve("mamba2-130m", np_params, b1, dec1)
        for name in ACCUM_CASES:
            want[("accum", name)] = _reference_accum(name, params[name], inputs[name][0])
        hist = []
        train(get_config("smollm-135m").reduced(), TrainLoopConfig(**LOOP), device="cpu",
              log_fn=lambda s, m: hist.append(m["loss"]))
        want["loop"] = hist
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
    return Saved(work), want, inputs, params


def test_ranks_import_neither_jax_nor_the_reference(world):
    saved = world[0]
    assert saved.meta["modules"] == []


@pytest.mark.parametrize("name", [*SERVE, "mamba2-b1"])
def test_sharded_prefill_and_decode_match(world, name):
    saved, want = world[0], world[1]
    got_caches = _nest(saved.tree(f"serve/{name}/caches/"))
    for src in ("ref", "one"):
        last, steps, caches = want[(src, name)]
        if name != "mamba2-b1":
            close(torch.from_numpy(saved.arr[f"serve/{name}/prefill"]), last, TOL, TOL)
        for s, w in enumerate(steps):
            close(torch.from_numpy(saved.arr[f"serve/{name}/decode{s}"]), w, TOL, TOL)
        if src == "ref":
            _close_caches(got_caches, caches)
        else:
            _close_caches(got_caches, jax.tree.map(lambda t: t.numpy(), caches))
    # The batch is sharded for B = 4 and replicated at B = 1 (long_500k).
    assert saved.meta[f"serve/{name}/rules_batch"] == (None if name == "mamba2-b1"
                                                       else ["data"])


def test_mixtral_microbatches_drop_tokens(world):
    """The capacity limit bites within a microbatch of the B1 case, so the
    rows that share a microbatch decide the result."""
    inputs, params = world[2], world[3]
    cfg = _cfg("mixtral-8x7b", grad_accum=ACCUM, **ACCUM_CASES["mixtral-8x7b"])
    api = build_model(cfg, device="cpu")
    model = load_reference_params(api.init(torch.Generator().manual_seed(0)),
                                  jax.tree.map(np.asarray, params["mixtral-8x7b"]))
    seen, orig = [], moe._slot_positions

    def spy(eh):
        slots = orig(eh)
        seen.append(int(slots.max()))
        return slots
    moe._slot_positions = spy
    try:
        mb = {k: v[: B // ACCUM] for k, v in inputs["mixtral-8x7b"][0].items()}
        with torch.no_grad():
            api.loss(model, mb)
    finally:
        moe._slot_positions = orig
    assert seen and max(seen) >= moe._capacity(cfg, T)


@pytest.mark.parametrize("name", sorted(ACCUM_CASES))
def test_grad_accum_on_mesh_matches_reference(world, name):
    saved, want = world[0], world[1][("accum", name)]
    # Each rank holds both microbatches of its batch rows: (accum, B/accum/2, T/2).
    assert saved.meta[f"accum/{name}/local"] == [ACCUM, B // ACCUM // 2, T // 2]
    loss = float(saved.arr[f"accum/{name}/loss"])
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (loss, want["loss"])
    grads = {k: v.numpy() for k, v in want["grads"].items()}
    tols = _assert_grads(saved.tree(f"accum/{name}/grad/"), grads, name)
    step_loss = float(saved.arr[f"accum/{name}/step/loss"])
    assert abs(step_loss - want["step_loss"]) <= LOSS_RTOL * abs(want["step_loss"])
    _assert_adamw_params(saved.tree(f"accum/{name}/step/param/"),
                         {k: v.numpy() for k, v in want["params"].items()}, grads, tols,
                         float(saved.arr[f"accum/{name}/step/lr"]), name)


def test_train_on_mesh_with_grad_accum(world):
    saved, want = world[0], world[1]["loop"]
    got = saved.meta["loop"]
    assert len(got) == len(want) == LOOP["total_steps"]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOOP_RTOL * abs(w), (got, want)
