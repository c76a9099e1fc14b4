"""The port's sharded GLCM (``repro_torch.core.distributed``) against the
reference (``repro.core.distributed``) on the CPU.

In process: the one-hot partial (``local_partial_nd`` / ``local_partial_glcm``)
against the reference's on the same numpy shards, halo rows of -1 and all;
the ``cuda_fused`` / ``cuda_volume`` hooks on CPU tensors (their kernels'
plain versions) against ``onehot``'s; the device-aware ``sharded_partial``
resolution; the registry's cap/hook pairing; every validation message, on a
one-rank gloo world.

Many ranks: each rank is a ``python -c`` child on a gloo world made from a
``FileStore`` under ``tmp_path`` (no TCP port: several test workers run at
once), with ``device="cpu"`` and one thread. The children replay the cases of
the reference's sharded test scripts (``test_distributed_glcm.py``,
``test_distributed_batch.py``, ``test_region.py``'s and ``test_volume.py``'s
sharded scripts) on a (4, 2) mesh of 8 ranks, a 3-rank world and inputs whose
rows outside each rank's block are poisoned, and write their blocks as
``.npy``; the parent assembles them in mesh order and holds them bit for bit
against the reference on the same inputs, and against the reference's own
``glcm_sharded`` run under 8 forced host devices. Every wait has a timeout,
so a deadlocked exchange fails the test. The ``cuda`` test runs 2 ranks on
the card and skips without one.
"""

import json
import os
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.core import backends  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.kernels.ref import glcm_offsets, glcm_offsets_3d  # noqa: E402

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp
    from repro.core import distributed as jdist
    from repro.core.glcm import glcm as jglcm
    from repro.core.schemes import glcm_scatter as jscatter
    from repro.core.spec import GLCMSpec as JaxSpec
except ImportError:
    jdist = None

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CHILD_TIMEOUT_S = 180
THETAS = (0, 45, 90, 135)
PAIRS_2D = ((1, 0), (1, 45), (4, 90), (2, 135))
PAIRS_3D = ((1, 0), (1, 3), (1, 4), (1, 8), (1, 12), (2, 9))


def _need_reference():
    if jdist is None:
        pytest.skip("the reference package needs JAX")


def _ext(rng, levels: int, local_n: int, d0: int, rest, sentinel: bool) -> np.ndarray:
    """A shard of ``local_n`` leading slices plus ``d0`` halo slices: -1 (the
    last shard) or levels (an inner one), with a few -1 pads inside."""
    ext = rng.integers(0, levels, size=(local_n + d0,) + tuple(rest)).astype(np.int32)
    if sentinel and d0:
        ext[local_n:] = -1
    ext.reshape(-1)[rng.integers(0, ext.size, size=3)] = -1
    return ext


# ---------------------------------------------------------------------------
# (a) In process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("theta", THETAS)
def test_local_partial_2d_matches_reference(theta, d, levels):
    _need_reference()
    rng = np.random.default_rng(100 * d + theta + levels)
    dy, dx = glcm_offsets(d, theta)
    for sentinel in (True, False):
        ext = _ext(rng, levels, 6, dy, (11,), sentinel)
        want = np.asarray(jdist.local_partial_glcm(jnp.asarray(ext), levels, dy, dx, 6))
        got = tdist.local_partial_glcm(torch.from_numpy(ext), levels, dy, dx, 6)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        got_nd = tdist.local_partial_nd(torch.from_numpy(ext), levels, (dy, dx), 6)
        np.testing.assert_array_equal(got_nd.numpy(), want)


@pytest.mark.parametrize("k", range(13))
def test_local_partial_3d_matches_reference(k):
    _need_reference()
    rng = np.random.default_rng(k)
    for d in (1, 2):
        off = glcm_offsets_3d(d, k)
        for levels in (8, 32):
            for sentinel in (True, False):
                ext = _ext(rng, levels, 3, off[0], (7, 9), sentinel)
                want = np.asarray(jdist.local_partial_nd(jnp.asarray(ext), levels, off, 3))
                got = tdist.local_partial_nd(torch.from_numpy(ext), levels, off, 3)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{off} L={levels}")


@pytest.mark.parametrize("name,ndim", [("cuda_fused", 2), ("cuda_volume", 3)])
def test_kernel_hooks_equal_onehot_on_cpu(name, ndim):
    hook = backends.get_backend(name).local_partial
    onehot = backends.get_backend("onehot").local_partial
    rng = np.random.default_rng(ndim)
    offsets = ([glcm_offsets(d, t) for d in (1, 2, 4) for t in THETAS] if ndim == 2
               else [glcm_offsets_3d(d, k) for d in (1, 2) for k in range(13)])
    rest = (13,) if ndim == 2 else (6, 7)
    for off in offsets:
        for local_n in (max(off[0], 1), 5):  # d0 == local_n is legal
            ext = torch.from_numpy(_ext(rng, 8, local_n, off[0], rest, True))
            got = hook(ext, 8, off, local_n)
            assert got.dtype == torch.int32 and got.shape == (8, 8)
            np.testing.assert_array_equal(got.numpy(), onehot(ext, 8, off, local_n).numpy(),
                                          err_msg=f"{name} {off} local_n={local_n}")


@pytest.mark.parametrize("name,ndim", [("onehot", 2), ("onehot", 3), ("cuda_fused", 2),
                                       ("cuda_volume", 3)])
def test_hooks_take_a_batch_of_shards(name, ndim):
    # glcm_sharded_batch counts a rank's whole batch of shards in one call.
    hook = backends.get_backend(name).local_partial
    rng = np.random.default_rng(7 + ndim)
    offsets = ([glcm_offsets(d, t) for d in (1, 4) for t in THETAS] if ndim == 2
               else [glcm_offsets_3d(d, k) for d in (1, 2) for k in (0, 4, 9, 12)])
    rest = (13,) if ndim == 2 else (6, 7)
    for off in offsets:
        ext = np.stack([_ext(rng, 8, 5, off[0], rest, sentinel) for sentinel in (True, False)])
        got = hook(torch.from_numpy(ext), 8, off, 5)
        assert got.dtype == torch.int32 and got.shape == (2, 8, 8)
        for b in range(2):
            want = tdist.local_partial_nd(torch.from_numpy(ext[b]), 8, off, 5)
            np.testing.assert_array_equal(got[b].numpy(), want.numpy(),
                                          err_msg=f"{name} {off} image {b}")


def test_cpu_plan_takes_a_kernel_backend_only_when_no_other_can():
    # Only the card's kernels declare batch_grid: a CPU plan still resolves,
    # to the first of them by name, whose compute gives its plain version.
    spec = GLCMSpec(levels=8)
    p = compile_plan(spec, (9, 9), require=("batch_grid",), device="cpu")
    assert p.spec.scheme == "cuda" and p.backend.caps.device_kernel
    img = np.random.default_rng(3).integers(0, 8, size=(9, 9))
    want = tdist.local_partial_nd(torch.from_numpy(np.concatenate([img, -np.ones((1, 9), int)])),
                                  8, (0, 1), 9)
    np.testing.assert_array_equal(p(torch.from_numpy(img))[0].numpy(), want.numpy())


def test_resolve_sharded_partial_by_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    img = GLCMSpec(levels=8, pairs=((1, 45),))
    vol = GLCMSpec(levels=8, pairs=((1, 9),), ndim=3)
    req = ("sharded_partial",)
    assert backends.resolve_scheme(img, cuda, require=req) == "cuda_fused"
    assert backends.resolve_scheme(vol, cuda, require=req) == "cuda_volume"
    assert backends.resolve_scheme(img, cpu, require=req) == "onehot"
    assert backends.resolve_scheme(vol, cpu, require=req) == "onehot"
    # compile_plan as the reference's test_capability_requirement_enforced
    with pytest.raises(ValueError, match="sharded_partial"):
        compile_plan(img.replace(scheme="scatter"), (32, 32), require=req, device="cpu")
    auto = compile_plan(img, (32, 32), require=req, device="cpu")
    assert auto.backend.name == "onehot" and auto.backend.caps.sharded_partial
    assert auto.backend.local_partial is not None
    declared = {n for n in backends.available_backends()
                if backends.get_backend(n).caps.sharded_partial}
    assert declared == {"onehot", "cuda_fused", "cuda_volume"}


def test_register_pairs_cap_and_hook():
    onehot = backends.get_backend("onehot")
    with pytest.raises(ValueError, match="sharded_partial"):
        backends.register(backends.Backend(
            name="scratch", compute=onehot.compute,
            caps=backends.Capabilities(sharded_partial=True)))
    with pytest.raises(ValueError, match="sharded_partial"):
        backends.register(backends.Backend(
            name="scratch", compute=onehot.compute, local_partial=onehot.local_partial))
    assert "scratch" not in backends.available_backends()


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo world in this process and a (1,) "data" mesh."""
    from repro_torch.launch.mesh import make_host_mesh

    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_host_mesh((1,), ("data",))
    finally:
        dist.destroy_process_group()


def test_validation_messages(world1):
    mesh = world1
    img = torch.zeros((8, 8), dtype=torch.int32)
    for fn in (tdist.glcm_sharded, tdist.glcm_sharded_batch, tdist.glcm_auto_sharded):
        with pytest.raises(ValueError, match="requires a mesh"):
            fn(img, 8, 1, 0, device="cpu")
        with pytest.raises(ValueError, match=r"pass either spec= or \(levels, d, theta\)"):
            fn(img, 8, 1, mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="not both"):
            fn(img, 8, mesh=mesh, spec=GLCMSpec(levels=8), device="cpu")
        with pytest.raises(ValueError, match="pre-quantized"):
            fn(img, mesh=mesh, spec=GLCMSpec(levels=8, quantize="uniform"), device="cpu")
        with pytest.raises(ValueError, match="single-offset"):
            fn(img, mesh=mesh, spec=GLCMSpec(levels=8, pairs=((1, 0), (1, 45))), device="cpu")
    vspec = GLCMSpec(levels=8, pairs=((1, 8),), ndim=3)
    stack = torch.zeros((2, 4, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="use glcm_sharded_batch for stacks"):
        tdist.glcm_sharded(stack, mesh=mesh, spec=vspec, device="cpu")
    with pytest.raises(ValueError, match="single"):
        tdist.glcm_auto_sharded(stack, mesh=mesh, spec=vspec, device="cpu")
    with pytest.raises(ValueError, match="expected a batched 4-D stack"):
        tdist.glcm_sharded_batch(stack[0], mesh=mesh, spec=vspec, row_axis=None, device="cpu")
    with pytest.raises(ValueError, match="lacks required capability 'sharded_partial'"):
        tdist.glcm_sharded(img, mesh=mesh, spec=GLCMSpec(levels=8, scheme="scatter"),
                           device="cpu")


def test_one_rank_world_matches_reference(world1):
    _need_reference()
    mesh = world1
    rng = np.random.default_rng(7)
    img = rng.integers(0, 8, size=(24, 20)).astype(np.int32)
    for d, t in PAIRS_2D:
        want = np.asarray(jscatter(jnp.asarray(img), 8, d, t))
        for fn in (tdist.glcm_sharded, tdist.glcm_auto_sharded):
            got = fn(img, 8, d, t, mesh, device="cpu")
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{fn.__name__} {d, t}")
        got = tdist.glcm_sharded_batch(img[None], 8, d, t, mesh, row_axis=None, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want[None])


def test_auto_refuses_counts_float32_cannot_hold(world1, monkeypatch):
    # The one-hot schemes vote in float32; a cell at 2**24 may be rounded.
    monkeypatch.setattr(tdist._backends, "compute_regions",
                        lambda *a, **k: torch.full((1, 1, 8, 8), 2.0**24))
    with pytest.raises(ValueError, match=r"reaches 2\*\*24"):
        tdist.glcm_auto_sharded(np.zeros((8, 8), np.int32), 8, 1, 0, world1, device="cpu")


def test_traced_stages(world1):
    from repro_torch.obs.trace import Tracer, set_tracer

    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    try:
        img = np.zeros((8, 8), np.int32)
        tdist.glcm_sharded(img, 8, 2, 90, world1, device="cpu")
    finally:
        set_tracer(prev)
    names = [s.name for s in tr.spans() if s.name.startswith("distributed.")]
    assert names == ["distributed.block", "distributed.halo", "distributed.partial",
                     "distributed.reduce"]


# ---------------------------------------------------------------------------
# (b) Many ranks, each a child process
# ---------------------------------------------------------------------------

# One rank. argv: rank, world, FileStore path, work directory, mode. Reads the
# inputs the parent saved (memmapped), runs the mode's cases and saves what
# it got, the messages of the cases that must raise, its mesh coordinate and
# the jax/repro modules it imported.
RANK_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, work, mode = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    from repro_torch.core.distributed import (
        glcm_auto_sharded, glcm_sharded, glcm_sharded_batch)
    from repro_torch.core.spec import GLCMSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.kernels import glcm_kernel

    DEV = "cuda" if mode == "cuda2" else "cpu"
    out, errors = {}, {}

    def load(name):
        return np.load(os.path.join(work, name + ".npy"), mmap_mode="r")

    def poisoned(x, lead, keep):
        # This rank's own copy of the global input: every slice of axis
        # ``lead`` outside ``keep`` (and every other image, for a batch)
        # set to level 0.
        y = np.array(x)
        idx = [slice(None)] * y.ndim
        idx[lead] = slice(None, keep.start)
        y[tuple(idx)] = 0
        idx[lead] = slice(keep.stop, None)
        y[tuple(idx)] = 0
        return y

    def raises(name, fn):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)
        else:
            errors[name] = None

    def save(key, t):
        out[key] = t.cpu().numpy()

    if mode in ("mesh8", "cuda2"):
        mesh = make_host_mesh((4, 2), ("data", "model")) if mode == "mesh8" else \\
            make_host_mesh((2,), ("data",))
        img = load("img")
        for d, t in PAIRS_2D:
            save(f"img/{d}/{t}/data", glcm_sharded(img, 8, d, t, mesh, axis="data", device=DEV))
            save(f"img/{d}/{t}/auto", glcm_auto_sharded(img, 8, d, t, mesh, axis="data",
                                                         device=DEV))
            if mode == "mesh8":
                save(f"img/{d}/{t}/flat", glcm_sharded(img, 8, d, t, mesh,
                                                       axis=("data", "model"), device=DEV))
    if mode == "cuda2":
        out["launches"] = np.array([glcm_kernel.glcm_fused.launches])

    if mode == "mesh8":
        out["coord"] = np.array(mesh.get_coordinate())
        flat = mesh.get_coordinate()[0] * 2 + mesh.get_coordinate()[1]
        # Poison: rows outside this rank's block of the flattened 8-way axis.
        for d, t in ((4, 90), (1, 45)):
            mine = poisoned(img, 0, slice(8 * flat, 8 * flat + 8))
            save(f"poison/img/{d}/{t}", glcm_sharded(mine, 8, d, t, mesh,
                                                      axis=("data", "model"), device=DEV))
        raises("indivisible", lambda: glcm_sharded(img[:60], 8, 1, 0, mesh,
                                                   axis=("data", "model"), device=DEV))
        raises("halo", lambda: glcm_sharded(img[:16], 8, 4, 90, mesh,
                                            axis=("data", "model"), device=DEV))

        imgs = load("imgs")
        for d, t in PAIRS_2D:
            save(f"batch/{d}/{t}/rows", glcm_sharded_batch(imgs, 8, d, t, mesh, device=DEV))
            save(f"batch/{d}/{t}/whole", glcm_sharded_batch(imgs, 8, d, t, mesh,
                                                            row_axis=None, device=DEV))
        i, j = mesh.get_coordinate()
        mine = poisoned(poisoned(imgs, 0, slice(2 * i, 2 * i + 2)), 1, slice(32 * j, 32 * j + 32))
        save("poison/batch", glcm_sharded_batch(mine, 8, 4, 90, mesh, device=DEV))
        raises("batch", lambda: glcm_sharded_batch(imgs[:3], 8, 1, 0, mesh, device=DEV))

        rimgs = load("rimgs")
        tspec = GLCMSpec(levels=8, pairs=((1, 45),), region="tiles", region_shape=(10, 8))
        save("tiles", glcm_sharded_batch(rimgs, mesh=mesh, spec=tspec, device=DEV))
        mesh1 = make_host_mesh((8,), ("data",))
        wspec = GLCMSpec(levels=8, pairs=((2, 90),), region="window", region_shape=(12, 16),
                         region_stride=(4, 8))
        save("windows", glcm_sharded(rimgs[0], mesh=mesh1, spec=wspec, device=DEV))
        save("windows/auto", glcm_auto_sharded(rimgs[0], mesh=mesh1, spec=wspec, device=DEV))
        # Grid row r covers image rows [4r, 4r + 12).
        mine = poisoned(rimgs[0], 0, slice(4 * rank, 4 * rank + 12))
        save("poison/windows", glcm_sharded(mine, mesh=mesh1, spec=wspec, device=DEV))
        raises("grid", lambda: glcm_sharded_batch(rimgs, mesh=mesh, device=DEV, spec=GLCMSpec(
            levels=8, pairs=((1, 0),), region="window", region_shape=(16, 8),
            region_stride=(12, 8))))

        vol = load("vol")
        for d, k in PAIRS_3D:
            spec = GLCMSpec(levels=8, pairs=((d, k),), ndim=3)
            save(f"vol/{d}/{k}/data", glcm_sharded(vol, mesh=mesh, axis="data", spec=spec,
                                                   device=DEV))
            save(f"vol/{d}/{k}/flat", glcm_sharded(vol, mesh=mesh, axis=("data", "model"),
                                                   spec=spec, device=DEV))
            save(f"vol/{d}/{k}/auto", glcm_auto_sharded(vol, mesh=mesh, axis="data",
                                                        spec=spec, device=DEV))
        spec = GLCMSpec(levels=8, pairs=((2, 9),), ndim=3)  # d0 == local_n == 2
        mine = poisoned(vol, 0, slice(2 * flat, 2 * flat + 2))
        save("poison/vol", glcm_sharded(mine, mesh=mesh, axis=("data", "model"), spec=spec,
                                        device=DEV))
        vols = load("vols")
        save("vol/batch", glcm_sharded_batch(vols, mesh=mesh, device=DEV,
                                             spec=GLCMSpec(levels=8, pairs=((1, 10),), ndim=3)))
        rspec = GLCMSpec(levels=8, pairs=((1, 4),), ndim=3, region="tiles",
                         region_shape=(4, 6, 10))
        save("vol/tiles", glcm_sharded(vol, mesh=mesh, axis="data", spec=rspec, device=DEV))

    if mode == "world3":
        mesh = make_host_mesh((3,), ("data",))
        img = load("img3")
        for d, t in ((2, 90), (1, 45), (1, 135)):
            save(f"img/{d}/{t}", glcm_sharded(img, 8, d, t, mesh, device=DEV))
            save(f"img/{d}/{t}/auto", glcm_auto_sharded(img, 8, d, t, mesh, device=DEV))
            mine = poisoned(img, 0, slice(16 * rank, 16 * rank + 16))
            save(f"poison/img/{d}/{t}", glcm_sharded(mine, 8, d, t, mesh, device=DEV))
        vol = load("vol3")
        save("vol", glcm_sharded(vol, mesh=mesh, device=DEV,
                                 spec=GLCMSpec(levels=8, pairs=((2, 9),), ndim=3)))
        wspec = GLCMSpec(levels=8, pairs=((1, 0),), region="window", region_shape=(15, 8),
                         region_stride=(4, 8))
        save("windows", glcm_sharded(img, mesh=mesh, spec=wspec, device=DEV))
        mesh13 = make_host_mesh((1, 3), ("data", "model"))
        save("batch", glcm_sharded_batch(load("imgs3"), 8, 2, 90, mesh13, device=DEV))

    np.savez(os.path.join(work, f"{mode}_r{rank}.npz"), **out)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    with open(os.path.join(work, f"{mode}_r{rank}.json"), "w") as f:
        json.dump({"errors": errors, "modules": loaded}, f)
    dist.destroy_process_group()
    """
).replace("PAIRS_2D", repr(PAIRS_2D)).replace("PAIRS_3D", repr(PAIRS_3D))

# The reference's own glcm_sharded over 8 forced host devices, on the first
# 2-D case.
REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core.distributed import glcm_sharded
    from repro.launch.mesh import make_host_mesh

    assert len(jax.devices()) == 8, jax.devices()
    work = sys.argv[1]
    mesh = make_host_mesh((4, 2), ("data", "model"))
    img = jnp.asarray(np.load(os.path.join(work, "img.npy")))
    np.save(os.path.join(work, "jax_sharded.npy"),
            np.asarray(glcm_sharded(img, 8, 1, 0, mesh, axis="data")))
    """
)


def _inputs(work: Path) -> None:
    rng = np.random.default_rng(0)
    arrays = {
        "img": (64, 96), "imgs": (8, 64, 96), "rimgs": (4, 40, 32), "vol": (16, 12, 20),
        "vols": (8, 8, 12, 20), "img3": (48, 40), "vol3": (9, 10, 12), "imgs3": (2, 48, 40),
    }
    for name, shape in arrays.items():
        np.save(work / f"{name}.npy", rng.integers(0, 8, size=shape).astype(np.int32))


def _start(args: list, env: dict, log: Path) -> tuple:
    """A child process whose output goes to ``log`` (a pipe could fill and
    block it)."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", *args], env=env, stdout=f,
                                stderr=subprocess.STDOUT), log


def _wait(procs, what: str) -> None:
    """Wait for every child; on a timeout kill them all and fail."""
    try:
        for p, _ in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        for p, _ in procs:
            p.wait()
        pytest.fail(f"{what}: a child did not finish in {CHILD_TIMEOUT_S} s (deadlock?)")
    for p, log in procs:
        assert p.returncode == 0, (
            f"{what}: child failed ({p.returncode}):\n{log.read_text()[-4000:]}")


def _spawn_ranks(work: Path, mode: str, world: int) -> list:
    store = work / f"{mode}.store"
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    return [_start([RANK_SCRIPT, str(r), str(world), str(store), str(work), mode], env,
                   work / f"{mode}_r{r}.log")
            for r in range(world)]


class Ranks:
    """What the children of one mode saved, by rank."""

    def __init__(self, work: Path, mode: str, world: int):
        self.work = work
        self.out = [dict(np.load(work / f"{mode}_r{r}.npz")) for r in range(world)]
        self.meta = [json.loads((work / f"{mode}_r{r}.json").read_text()) for r in range(world)]

    def every(self, key: str) -> list[np.ndarray]:
        return [o[key] for o in self.out]

    def load(self, name: str) -> np.ndarray:
        return np.load(self.work / f"{name}.npy")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8-rank (4, 2) mesh run, the 3-rank world run and the reference's
    sharded run, started together; (mesh8, world3)."""
    _need_reference()
    work = tmp_path_factory.mktemp("ranks")
    _inputs(work)
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu"}
    ref = _start([REFERENCE_SCRIPT, str(work)], env, work / "reference.log")
    procs = [ref] + _spawn_ranks(work, "mesh8", 8) + _spawn_ranks(work, "world3", 3)
    _wait(procs, "sharded runs")
    return Ranks(work, "mesh8", 8), Ranks(work, "world3", 3)


def _whole(got: list[np.ndarray], want: np.ndarray, what: str) -> None:
    for r, g in enumerate(got):
        assert g.dtype == np.int32, f"{what}: rank {r} gave {g.dtype}"
        np.testing.assert_array_equal(g, want, err_msg=f"{what}: rank {r}")


def _scatter(x: np.ndarray, d, t) -> np.ndarray:
    return np.asarray(jscatter(jnp.asarray(x), 8, d, t))


@pytest.mark.parametrize("pair", PAIRS_2D)
def test_sharded_2d_8_ranks(ranks, pair):
    mesh8, _ = ranks
    d, t = pair
    want = _scatter(mesh8.load("img"), d, t)
    for how in ("data", "flat", "auto"):
        _whole(mesh8.every(f"img/{d}/{t}/{how}"), want, f"{pair} {how}")


def test_sharded_equals_reference_run_sharded(ranks):
    mesh8, _ = ranks
    want = np.load(mesh8.work / "jax_sharded.npy")
    _whole(mesh8.every("img/1/0/data"), want, "reference glcm_sharded")


def _by_batch(mesh8: Ranks, key: str) -> np.ndarray:
    """Rank blocks of a batch split over "data" in mesh order (model 0),
    after checking every rank of a row group holds the same block."""
    blocks = {}
    for o in mesh8.out:
        i, _ = o["coord"]
        if i in blocks:
            np.testing.assert_array_equal(o[key], blocks[i], err_msg=f"{key}: row group {i}")
        blocks[i] = o[key]
    return np.concatenate([blocks[i] for i in sorted(blocks)])


@pytest.mark.parametrize("pair", PAIRS_2D)
def test_sharded_batch_8_ranks(ranks, pair):
    mesh8, _ = ranks
    d, t = pair
    want = _scatter(mesh8.load("imgs"), d, t).astype(np.int32)
    for how in ("rows", "whole"):
        np.testing.assert_array_equal(_by_batch(mesh8, f"batch/{d}/{t}/{how}"), want,
                                      err_msg=f"{pair} {how}")


def test_sharded_region_grid_8_ranks(ranks):
    mesh8, _ = ranks
    rimgs = mesh8.load("rimgs")
    # Tiles on (4, 2): batch over "data", grid rows over "model".
    want = np.asarray(jglcm(jnp.asarray(rimgs), 8, 1, 45, scheme="onehot", region="tiles",
                            region_shape=(10, 8))).astype(np.int32)
    assert want.shape == (4, 4, 4, 8, 8)
    got = np.zeros_like(want)
    for o in mesh8.out:
        i, j = o["coord"]
        assert o["tiles"].shape == (1, 2, 4, 8, 8) and o["tiles"].dtype == np.int32
        got[i, 2 * j: 2 * j + 2] = o["tiles"][0]
    np.testing.assert_array_equal(got, want)
    # Windows on (8,): one grid row per rank; auto returns the whole map.
    want = np.asarray(jglcm(jnp.asarray(rimgs[0]), 8, 2, 90, scheme="onehot", region="window",
                            region_shape=(12, 16), region_stride=(4, 8))).astype(np.int32)
    assert want.shape == (8, 3, 8, 8)
    np.testing.assert_array_equal(np.concatenate(mesh8.every("windows")), want)
    _whole(mesh8.every("windows/auto"), want, "windows auto")


@pytest.mark.parametrize("pair", PAIRS_3D)
def test_sharded_volume_8_ranks(ranks, pair):
    mesh8, _ = ranks
    d, k = pair
    vol = mesh8.load("vol")
    want = np.asarray(jscatter(jnp.asarray(vol), 8, offset=JaxSpec(
        levels=8, pairs=(pair,), ndim=3).offsets()[0]))
    for how in ("data", "flat", "auto"):  # flat (2, 9): d0 == local_n == 2
        _whole(mesh8.every(f"vol/{d}/{k}/{how}"), want, f"{pair} {how}")


def test_sharded_volume_batch_and_tiles_8_ranks(ranks):
    mesh8, _ = ranks
    vols, vol = mesh8.load("vols"), mesh8.load("vol")
    off = JaxSpec(levels=8, pairs=((1, 10),), ndim=3).offsets()[0]
    want = np.asarray(jscatter(jnp.asarray(vols), 8, offset=off)).astype(np.int32)
    np.testing.assert_array_equal(_by_batch(mesh8, "vol/batch"), want)
    want = np.asarray(jglcm(jnp.asarray(vol), 8, 1, 4, ndim=3, scheme="onehot", region="tiles",
                            region_shape=(4, 6, 10))).astype(np.int32)
    assert want.shape == (4, 2, 2, 8, 8)
    # Grid rows over "data"; the "model" ranks repeat their row's block.
    for o in mesh8.out:
        i, _ = o["coord"]
        np.testing.assert_array_equal(o["vol/tiles"], want[i: i + 1])


def test_poisoned_rows_never_read(ranks):
    """Each rank's copy of the input has level 0 outside its own block: the
    counts stay exact only if every halo came through the exchange."""
    mesh8, world3 = ranks
    img = mesh8.load("img")
    for d, t in ((4, 90), (1, 45)):
        _whole(mesh8.every(f"poison/img/{d}/{t}"), _scatter(img, d, t), f"poison {d, t}")
    np.testing.assert_array_equal(_by_batch(mesh8, "poison/batch"),
                                  _scatter(mesh8.load("imgs"), 4, 90).astype(np.int32))
    want = np.asarray(jglcm(jnp.asarray(mesh8.load("rimgs")[0]), 8, 2, 90, scheme="onehot",
                            region="window", region_shape=(12, 16), region_stride=(4, 8)))
    np.testing.assert_array_equal(np.concatenate(mesh8.every("poison/windows")),
                                  want.astype(np.int32))
    off = JaxSpec(levels=8, pairs=((2, 9),), ndim=3).offsets()[0]
    _whole(mesh8.every("poison/vol"),
           np.asarray(jscatter(jnp.asarray(mesh8.load("vol")), 8, offset=off)), "poison vol")
    img3 = world3.load("img3")
    for d, t in ((2, 90), (1, 45), (1, 135)):
        _whole(world3.every(f"poison/img/{d}/{t}"), _scatter(img3, d, t), f"3 ranks poison {d, t}")


def test_three_rank_world(ranks):
    _, world3 = ranks
    img = world3.load("img3")
    for d, t in ((2, 90), (1, 45), (1, 135)):
        want = _scatter(img, d, t)
        _whole(world3.every(f"img/{d}/{t}"), want, f"3 ranks {d, t}")
        _whole(world3.every(f"img/{d}/{t}/auto"), want, f"3 ranks auto {d, t}")
    off = JaxSpec(levels=8, pairs=((2, 9),), ndim=3).offsets()[0]
    _whole(world3.every("vol"), np.asarray(jscatter(jnp.asarray(world3.load("vol3")), 8,
                                                    offset=off)), "3 ranks vol")
    want = np.asarray(jglcm(jnp.asarray(img), 8, 1, 0, scheme="onehot", region="window",
                            region_shape=(15, 8), region_stride=(4, 8))).astype(np.int32)
    assert want.shape[0] == 9
    np.testing.assert_array_equal(np.concatenate(world3.every("windows")), want)
    _whole(world3.every("batch"), _scatter(world3.load("imgs3"), 2, 90).astype(np.int32),
           "3 ranks batch")


def test_sharded_error_paths_8_ranks(ranks):
    mesh8, _ = ranks
    for meta in mesh8.meta:
        errors = meta["errors"]
        assert errors["indivisible"] == "leading extent 60 not divisible by 8 shards"
        assert errors["halo"] == "halo 4 exceeds shard extent 2"
        assert errors["batch"] == "batch 3 not divisible by 4 shards"
        # (40 - 16) // 12 + 1 = 3 grid rows over 2 "model" ranks
        assert errors["grid"] == "region grid extent 3 not divisible by 2 shards"


def test_rank_processes_import_no_jax(ranks):
    for run in ranks:
        for meta in run.meta:
            assert meta["modules"] == []


@pytest.mark.cuda
def test_sharded_two_ranks_on_the_card(tmp_path):
    """2 gloo ranks with ``device="cuda"``: the 2-D cases and auto, counted by
    ``glcm_fused`` (launches in each rank) and equal to the port's plain
    counts of the whole input."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.core.schemes import glcm_scatter

    _inputs(tmp_path)
    _wait(_spawn_ranks(tmp_path, "cuda2", 2), "cuda ranks")
    run = Ranks(tmp_path, "cuda2", 2)
    img = torch.from_numpy(run.load("img"))
    for d, t in PAIRS_2D:
        want = glcm_scatter(img, 8, d, t).numpy()
        for how in ("data", "auto"):
            _whole(run.every(f"img/{d}/{t}/{how}"), want, f"cuda {d, t} {how}")
    for launches in run.every("launches"):
        assert launches[0] >= 2 * len(PAIRS_2D)
