"""The MoE layer and the Mamba2 mixer computed sharded over "model" on a mesh
(mesh row B4) against the reference's layers, and what ``launch.cost``
counts of them, on the CPU.

One spawned world of 4 gloo ranks (``python -c`` children on a ``FileStore``
under ``tmp_path``, one thread each, ``device="cpu"``; the parent kills them
after CHILD_TIMEOUT_S) runs every case on a (1, 4) and a (2, 2) ("data",
"model") mesh, and one fake world of 4 ranks (backend "fake", a child of its
own) counts. The parent holds what rank 0 saved against the reference's
``apply_moe`` / ``apply_mamba`` on the same parameters (the reference's
``init_moe`` / ``init_mamba``, carried over by name), float32, B = 4:

* ``apply_moe`` of reduced mixtral-8x7b (d_ff over "model", one-hot
  dispatch) and arctic-480b (experts over "model", indexed dispatch, the
  dense residual) at capacity factor 1.0 and T = 32: the output, the aux loss
  and the gradients of sum(y · c) + 3 · aux with respect to the input and
  every parameter. The parent checks that votes drop whose slot counts the
  votes of earlier "model" ranks (a rank-local count would have kept them);
* ``apply_moe`` at decode (T = 1, the token on every "model" rank) without
  grad;
* ``apply_mamba`` of reduced mamba2-130m with an initial state and
  ``return_state``: T = 32 (each rank's block whole chunks: the conv halo and
  the state combine) and T = 20 (blocks of 5 and 10 are not whole chunks of
  8: the reference's rule leaves the chunk axis unsharded), the output, the
  final state and the gradients of sum(y · c) + sum(state · c_s) with
  respect to the input, the initial state and every parameter.

Tolerances: values within 1e-4 (``test_torch_lm_mesh_cells.py``'s), each
gradient within 1e-5 of its max |g| plus 1e-6 of the largest
(``test_torch_lm_mesh.py``'s).

Counting: on the fake (1, 4) world, each layer's forward and backward at
T = 32 counts at most 0.4 of the one-process flops a rank (ideal 0.25); and
the train cells of reduced mixtral, arctic and mamba2 on (1, 4), run by
``run_program`` on real values in the gloo world and by ``lower_cell`` on
fake ones, count the same flops, bytes and collective bytes on every rank.
"""

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
from repro_torch.models.convert import flatten_paths  # noqa: E402

try:  # the reference needs JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import moe as jm
    from repro.models import ssm as js
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CHILD_TIMEOUT_S = 240
WORLD = 4
B = 4
MESHES = ((1, 4), (2, 2))
TOL, LEAF_RTOL, MODEL_RTOL, COUNT_RATIO = 1e-4, 1e-5, 1e-6, 0.4
# name: (arch, config overrides, T, with gradients)
MOE = {"mixtral": ("mixtral-8x7b", {"capacity_factor": 1.0}, 32, True),
       "arctic": ("arctic-480b", {"capacity_factor": 1.0}, 32, True),
       "mixtral-decode": ("mixtral-8x7b", {}, 1, False),
       "arctic-decode": ("arctic-480b", {}, 1, False)}
MIXER = {"chunks": ("mamba2-130m", {}, 32, True),
         "unsharded": ("mamba2-130m", {}, 20, True)}
CELLS = ("mixtral-8x7b", "arctic-480b", "mamba2-130m")
CELL_T = 32


def _cfg(pkg, arch, over):
    return pkg(arch).reduced(**over)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_paths(tree)}


def _savez(path: Path, flat: dict) -> None:
    np.savez(path, **{k.replace("/", "|"): np.asarray(v) for k, v in flat.items()})


# One rank. argv: rank, FileStore path, work directory.
RANK_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch import nn

    rank, store, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.cost import measure
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, make_train_step, place_args, run_program
    from repro_torch.models import build_model, moe, ssm
    from repro_torch.sharding.partition import P, NamedSharding, distribute
    from repro_torch.train.loop import on_mesh, shard_params

    CPU = torch.device("cpu")
    out, meta = {}, {}

    def save(key, t):
        out[key] = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()

    def load(name):
        with np.load(os.path.join(work, name + ".npz")) as z:
            return {k.replace("|", "/"): z[k] for k in z.files}

    def layer(kind, cfg, name, mesh):
        holder = nn.Module()
        setattr(holder, kind, moe.MoE(cfg) if kind == "moe" else ssm.Mamba(cfg))
        getattr(holder, kind).load_state_dict(
            {k.replace("/", "."): torch.from_numpy(v) for k, v in load(name + ".params").items()})
        return holder, getattr(shard_params(cfg, holder, mesh), kind)

    def placed(x, mesh, *spec):
        return distribute(torch.from_numpy(x), NamedSharding(mesh, P(*spec)))

    for shape in MESHES:
        mesh = make_host_mesh(shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        seq = lambda t: "model" if t % shape[1] == 0 else None
        for name, (arch, over, t, grads) in {**MOE, **MIXER}.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), **over)
            kind = "moe" if name in MOE else "mamba"
            holder, mod = layer(kind, cfg, name, mesh)
            io = load(name + ".io")
            x = placed(io["x"], mesh, "data", seq(t), None).requires_grad_(grads)
            c = placed(io["c"], mesh, "data", seq(t), None)
            with on_mesh(cfg, mesh), torch.set_grad_enabled(grads):
                if kind == "moe":
                    y, extra = moe.apply_moe(cfg, mod, x)
                    loss = (y * c).sum() + 3.0 * extra
                else:
                    s0 = placed(io["s0"], mesh, "data", None, None, None).requires_grad_()
                    y, extra = ssm.apply_mamba(cfg, mod, x, initial_state=s0, return_state=True)
                    loss = (y * c).sum() + (extra * placed(io["cs"], mesh, "data", None, None,
                                                          None)).sum()
                if grads:
                    loss.backward()
            key = f"{tag}/{name}"
            save(key + "/y", y)
            save(key + "/extra", extra)
            meta[key + "/placements"] = [str(p) for p in y.placements]
            if grads:
                save(key + "/grad/x", x.grad)
                if kind == "mamba":
                    save(key + "/grad/s0", s0.grad)
                for n, p in holder.named_parameters():
                    save(key + "/grad/" + n.split(".", 1)[1].replace(".", "/"), p.grad)

    # The reduced train cells on (1, 4), counted on real values.
    mesh = make_host_mesh((1, 4), ("data", "model"))
    for arch in CELLS:
        cfg = get_config(arch).reduced(vocab_size=256)
        prog = build_cell(cfg, ShapeCell("t", "train", CELL_T, B), mesh)
        model = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
        opt = make_train_step(cfg, device=CPU)[1](model)
        tokens = np.random.default_rng(0).integers(0, 256, (B, CELL_T)).astype(np.int32)
        args = place_args(prog, (model, opt, {"tokens": tokens}))
        _, rec = measure(lambda *a: run_program(prog, mesh, a), *args)
        meta[f"cell/{arch}"] = rec.costs()

    with open(os.path.join(work, f"counts{rank}.json"), "w") as f:
        json.dump({k: v for k, v in meta.items() if k.startswith("cell/")}, f)
    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"),
                 **{k.replace("/", "|"): v for k, v in out.items()})
        meta["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(work, "rank0.json"), "w") as f:
            json.dump(meta, f)
    dist.destroy_process_group()
    """
)

# The fake world: per-layer counts on (1, 4) against one process, and the
# train cells by lower_cell. argv: output path.
FAKE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import torch
    import torch.distributed as dist
    from torch import nn
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.cost import measure
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, lower_cell
    from repro_torch.models import moe, ssm
    from repro_torch.sharding.partition import P, NamedSharding, distribute
    from repro_torch.train.loop import on_mesh, shard_params

    mesh = make_host_mesh((1, 4), ("data", "model"))
    out = {}
    with FakeTensorMode():
        for arch, kind in (("mixtral-8x7b", "moe"), ("arctic-480b", "moe"),
                           ("mamba2-130m", "mamba")):
            cfg = get_config(arch).reduced()
            apply = moe.apply_moe if kind == "moe" else ssm.apply_mamba

            def step(x, mod):
                y = apply(cfg, mod, x)
                y, extra = y if isinstance(y, tuple) else (y, 0.0)
                (y.sum() + extra).backward()

            holder = nn.Module()
            setattr(holder, kind, moe.MoE(cfg) if kind == "moe" else ssm.Mamba(cfg))
            x = torch.empty(B, CELL_T, cfg.d_model).requires_grad_()
            _, one = measure(step, x, getattr(holder, kind))
            shard_params(cfg, holder, mesh)
            xd = distribute(x.detach(), NamedSharding(mesh, P("data", "model", None)))
            with on_mesh(cfg, mesh):
                _, rank = measure(step, xd.requires_grad_(), getattr(holder, kind))
            out[f"layer/{arch}"] = {"one_process": one.flops, "rank": rank.flops,
                                    "coll": rank.coll_bytes}
    for arch in CELLS:
        cfg = get_config(arch).reduced(vocab_size=256)
        out[f"cell/{arch}"] = lower_cell(build_cell(cfg, ShapeCell("t", "train", CELL_T, B),
                                                    mesh), mesh).costs()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)
# The constants both scripts read.
PRELUDE = (f"WORLD, B, MESHES, MOE, MIXER, CELLS, CELL_T = "
           f"{WORLD!r}, {B!r}, {MESHES!r}, {MOE!r}, {MIXER!r}, {CELLS!r}, {CELL_T!r}\n")


def _reference(work: Path) -> dict:
    """The reference's parameters and inputs for each case (written for the
    ranks), and its outputs and gradients."""
    want = {}
    for name, (arch, over, t, grads) in {**MOE, **MIXER}.items():
        jcfg = _cfg(jget, arch, over)
        rng = np.random.default_rng(len(name))
        key = jax.random.key(len(name))
        io = {"x": rng.normal(size=(B, t, jcfg.d_model)).astype(np.float32),
              "c": rng.normal(size=(B, t, jcfg.d_model)).astype(np.float32)}
        if name in MOE:
            params = jax.tree.map(np.asarray, jm.init_moe(jcfg, key))

            def loss(p, x, c, s0=None, cs=None):
                y, aux = jm.apply_moe(jcfg, p, x)
                return jnp.sum(y * c) + 3.0 * aux, (y, aux)
        else:
            params = jax.tree.map(np.asarray, js.init_mamba(jcfg, key))
            io["s0"] = (0.1 * rng.normal(size=(B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                               jcfg.ssm_state))).astype(np.float32)
            io["cs"] = rng.normal(size=io["s0"].shape).astype(np.float32)

            def loss(p, x, c, s0=None, cs=None):
                y, st = js.apply_mamba(jcfg, p, x, initial_state=s0, return_state=True)
                return jnp.sum(y * c) + jnp.sum(st * cs), (y, st)
        _savez(work / f"{name}.params.npz", _flat(params))
        _savez(work / f"{name}.io.npz", io)
        args = {k: jnp.asarray(v) for k, v in io.items()}
        (_, (y, extra)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 3) if "s0" in io else (0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), args["x"], args["c"], args.get("s0"),
            args.get("cs"))
        w = {"y": np.asarray(y), "extra": np.asarray(extra)}
        if grads:
            w["grad"] = {**_flat(jax.tree.map(np.asarray, g[0])), "x": np.asarray(g[1])}
            if "s0" in io:
                w["grad"]["s0"] = np.asarray(g[2])
        if name in MOE:
            w["ids"] = np.asarray(jm.route(jcfg, jax.tree.map(jnp.asarray, params),
                                           args["x"])[0])
            w["cap"] = jm._capacity(jcfg, t)
        want[name] = w
    return want


class Saved:
    def __init__(self, work: Path, fake: dict):
        with np.load(work / "rank0.npz") as z:
            self.arr = {k.replace("|", "/"): z[k] for k in z.files}
        self.meta = json.loads((work / "rank0.json").read_text())
        self.counts = [json.loads((work / f"counts{r}.json").read_text()) for r in range(WORLD)]
        self.fake = fake

    def tree(self, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in self.arr.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's results for every case, the gloo world's and the fake
    world's."""
    if jax is None:
        pytest.skip("the reference package needs JAX")
    work = tmp_path_factory.mktemp("lm_mesh_b4")
    want = _reference(work)
    store = work / "world.store"
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(WORLD):
        log = open(work / f"r{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", PRELUDE + RANK_SCRIPT, str(r),
                                        str(store), str(work)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    log = open(work / "fake.log", "w")
    procs.append((subprocess.Popen([sys.executable, "-c", PRELUDE + FAKE_SCRIPT,
                                    str(work / "fake.json")],
                                   env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a child did not finish in {CHILD_TIMEOUT_S} s (deadlock?)")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for _, log in procs:
            log.close()
    for r, (p, _) in enumerate(procs):
        name = f"r{r}.log" if r < WORLD else "fake.log"
        assert p.returncode == 0, (work / name).read_text()[-4000:]
    return Saved(work, json.loads((work / "fake.json").read_text())), want


def _assert_grads(got: dict, want: dict, what: str) -> None:
    """``test_torch_lm_mesh.py``'s gradient tolerances."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    top = max(float(np.abs(w).max()) for w in want.values())
    assert top > 0, what
    for n, w in want.items():
        tol = LEAF_RTOL * float(np.abs(w).max()) + MODEL_RTOL * top
        d = float(np.abs(got[n] - w).max())
        assert d <= tol, f"{what} {n}: max |Δ| {d} > {tol}"


def _mesh_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def test_ranks_import_neither_jax_nor_the_reference(world):
    saved, _ = world
    assert saved.meta["modules"] == []


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_on_mesh_matches_reference(world, name, mesh):
    saved, want = world
    key = f"{_mesh_id(mesh)}/{name}"
    w = want[name]
    np.testing.assert_allclose(saved.arr[key + "/y"], w["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(saved.arr[key + "/extra"], w["extra"], rtol=TOL, atol=TOL)
    t = MOE[name][2]
    # The output keeps the input's placements: batch over "data", the
    # sequence over "model" where it divides.
    assert saved.meta[key + "/placements"] == ["S(0)", "S(1)" if t % mesh[1] == 0 else "R"]
    if MOE[name][3]:
        _assert_grads(saved.tree(key + "/grad/"), w["grad"], key)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", sorted(MIXER))
def test_mixer_on_mesh_matches_reference(world, name, mesh):
    saved, want = world
    key = f"{_mesh_id(mesh)}/{name}"
    w = want[name]
    np.testing.assert_allclose(saved.arr[key + "/y"], w["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(saved.arr[key + "/extra"], w["extra"], rtol=TOL, atol=TOL)
    _assert_grads(saved.tree(key + "/grad/"), w["grad"], key)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", ["mixtral", "arctic"])
def test_moe_drops_votes_across_rank_boundaries(world, name, mesh):
    """Some votes drop only because the votes of earlier "model" ranks fill
    their expert's slots: a rank-local slot count would have kept them."""
    _, want = world
    ids, cap = want[name]["ids"], want[name]["cap"]
    bsz, t, k = ids.shape
    e = get_config(MOE[name][0]).reduced().num_experts
    eh = np.eye(e, dtype=np.int64)[ids.reshape(bsz, t * k)]           # (B, T*K, E)
    slots = ((np.cumsum(eh, 1) - eh) * eh).sum(-1)
    block = t // mesh[1] * k
    local = np.concatenate([((np.cumsum(b, 1) - b) * b).sum(-1)
                            for b in np.split(eh, t * k // block, axis=1)], axis=1)
    assert (slots >= cap).any()
    assert ((slots >= cap) & (local < cap)).any()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b", "mamba2-130m"])
def test_layer_flops_per_rank_on_fake_world(world, arch):
    saved, _ = world
    c = saved.fake[f"layer/{arch}"]
    assert c["rank"] > 0 and c["rank"] <= COUNT_RATIO * c["one_process"], c
    assert sum(c["coll"].values()) > 0, c


@pytest.mark.parametrize("arch", CELLS)
def test_real_and_fake_worlds_count_the_same(world, arch):
    saved, _ = world
    fake = saved.fake[f"cell/{arch}"]
    assert fake["flops"] > 0 and sum(fake["coll_bytes"].values()) > 0
    for r, counts in enumerate(saved.counts):
        assert counts[f"cell/{arch}"] == fake, (r, counts[f"cell/{arch}"], fake)
