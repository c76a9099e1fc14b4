"""The port's sharding rules (``repro_torch.sharding``, ``launch.mesh``)
against the reference's (``repro.sharding``, ``repro.launch.mesh``), on
the CPU.

Specs are compared entry for entry: every leaf of all ten archs at their
full published configs (the reference's ``jax.eval_shape`` trees; the port
reads only ``.shape``), the per-layer form of the port's reduced modules,
batch / cache / logits / decode-token / optimizer-state specs and the
logical rules. Placements (``named``), the production meshes and the
divisibility of every full-config leaf run on fake process groups
(``torch.testing._internal.distributed.fake_pg``, backend "fake": no
collective runs). The routed functional collectives of ``sharding.gloo_cuda``
run on a 4-rank gloo world of ``python -c`` children on the CPU, and refuse
a fake world's group in a child that routed.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_compat_mesh,
    make_production_mesh,
    required_devices,
)
from repro_torch.launch.steps import _cell_rules  # noqa: E402
from repro_torch.models.common import remat_call  # noqa: E402
from repro_torch.models.convert import flatten_paths, is_stacked  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.sharding import logical  # noqa: E402
from repro_torch.sharding import partition as shd  # noqa: E402
from repro_torch.sharding.partition import P  # noqa: E402

try:  # the reference needs JAX
    import jax
    from repro.configs import get_config as jget
    from repro.launch.steps import _cell_rules as j_cell_rules
    from repro.models import build_model as jbuild
    from repro.sharding import logical as jlogical
    from repro.sharding import partition as jshd
    from repro.train.optimizer import make_optimizer as jmake_optimizer
except ImportError:
    jax = None

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _need_reference():
    if jax is None:
        pytest.skip("the reference package needs JAX")


def _canon(spec) -> tuple:
    """A spec's entries, a one-name tuple as the name (JAX >= 0.5 stores it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _is_spec(x) -> bool:
    return isinstance(x, (P, jax.sharding.PartitionSpec))


def _pairs(got, want, path=""):
    """(path, port spec, reference spec) over two spec trees of one structure."""
    if _is_spec(want):
        assert _is_spec(got), path
        yield path, got, want
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, (list, tuple)) and len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
        yield from _pairs(g, w, f"{path}/{i}")


def _assert_specs_equal(got, want) -> int:
    n = 0
    for path, g, w in _pairs(got, want):
        assert _canon(g) == _canon(w), f"{path}: {g} vs {w}"
        n += 1
    return n


class _Names:
    """A mesh as the spec functions read it: the port's ``mesh_dim_names``
    and the reference's ``axis_names``."""

    def __init__(self, names):
        self.mesh_dim_names = self.axis_names = tuple(names)


SINGLE, MULTI = _Names(("data", "model")), _Names(("pod", "data", "model"))


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A fake process group of ``size`` ranks in this process."""
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _reference_params(arch):
    jcfg = jget(arch)
    return jcfg, jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0)))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_full_config(arch):
    _need_reference()
    jcfg, params = _reference_params(arch)
    got = shd.param_specs(get_config(arch), params)
    want = jshd.param_specs(jcfg, params)
    assert _assert_specs_equal(got, want) == len(jax.tree.leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_specs_equal_reference(arch):
    _need_reference()
    jcfg, params = _reference_params(arch)
    _, jinit, _ = jmake_optimizer(jcfg.optimizer)
    opt = jax.eval_shape(jinit, params)
    pspecs = shd.param_specs(get_config(arch), params)
    got = shd.optimizer_state_specs(pspecs, opt)
    want = jshd.optimizer_state_specs(jshd.param_specs(jcfg, params), opt)
    _assert_specs_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_module_specs_are_each_layers_spec(arch):
    """The port's per-layer parameters (``group_0/3/attn/wq``) get the
    reference's stacked spec without its layer entry."""
    _need_reference()
    cfg = get_config(arch).reduced()
    model = model_module(cfg, device="meta")
    specs = dict(flatten_paths(shd.param_specs(cfg, model)))
    shapes = {n.replace(".", "/"): p.shape for n, p in model.named_parameters()}
    assert set(specs) == set(shapes)
    for path, spec in specs.items():
        top, *rest = path.split("/")
        if rest and rest[0].isdigit():   # a layer of a stacked group
            ref = jshd.spec_for_path(jget(arch).reduced(), "/".join([top, *rest[1:]]),
                                     len(shapes[path]) + 1)
            assert is_stacked("/".join([top, *rest[1:]])) and ref[0] is None, path
            ref = tuple(ref)[1:]
        else:
            ref = jshd.spec_for_path(jget(arch).reduced(), path, len(shapes[path]))
        assert _canon(spec) == _canon(ref), path


@pytest.mark.parametrize("arch,path,ndim", [
    ("llava-next-34b", "embeddings/embed", 2), ("llava-next-34b", "group_0/attn/wq", 4),
    ("llava-next-34b", "group_0/mlp/w_gate", 3), ("llava-next-34b", "group_0/mlp/w_down", 3),
    ("llava-next-34b", "group_0/ln1/scale", 2), ("smollm-135m", "group_0/mlp/w_gate", 3),
    ("smollm-135m", "embeddings/embed", 2), ("arctic-480b", "group_0/moe/w_gate", 4),
    ("arctic-480b", "group_0/moe/w_down", 4), ("mixtral-8x7b", "group_0/moe/w_gate", 4),
    ("mixtral-8x7b", "group_0/moe/router", 3), ("hymba-1.5b", "group_0/mamba/in_proj", 3),
    ("hymba-1.5b", "group_0/mamba/conv_w", 3), ("mamba2-130m", "group_0/mamba/in_proj", 3),
    ("whisper-medium", "decoder/cross_attn/wq", 4), ("hymba-1.5b", "meta", 2),
])
def test_spec_for_known_paths(arch, path, ndim):
    """The reference's ``test_sharding.py`` paths, port against reference."""
    _need_reference()
    got = shd.spec_for_path(get_config(arch), path, ndim)
    assert isinstance(got, P) and len(got) == ndim
    assert _canon(got) == _canon(jshd.spec_for_path(jget(arch), path, ndim))


# ---------------------------------------------------------------------------
# Batch, cache, logits, decode-token specs; rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_equal_reference(arch):
    _need_reference()
    cfg, jcfg = get_config(arch), jget(arch)
    caches = jax.eval_shape(lambda: jbuild(jcfg).init_caches(4, 32, 16))
    for mesh in (SINGLE, MULTI):
        assert shd.batch_axes(mesh) == jshd.batch_axes(mesh)
        for seq_shard in (True, False):
            _assert_specs_equal(shd.batch_specs(cfg, mesh, seq_shard=seq_shard),
                                jshd.batch_specs(jcfg, mesh, seq_shard=seq_shard))
        for sharded in (True, False):
            assert _canon(shd.logits_spec(cfg, mesh, sharded)) == _canon(
                jshd.logits_spec(jcfg, mesh, sharded))
            got, want = (shd.decode_token_specs(cfg, mesh, sharded),
                         jshd.decode_token_specs(jcfg, mesh, sharded))
            assert [_canon(s) for s in got] == [_canon(s) for s in want]
            for layout in ("context", "heads_tp"):
                c = dataclasses.replace(cfg, attn_layout=layout)
                jc = dataclasses.replace(jcfg, attn_layout=layout)
                _assert_specs_equal(shd.cache_specs(c, mesh, caches, batch_sharded=sharded),
                                    jshd.cache_specs(jc, mesh, caches, batch_sharded=sharded))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_reference(arch):
    _need_reference()
    for mesh in (SINGLE, MULTI):
        assert logical.default_rules(mesh) == jlogical.default_rules(mesh)
        for layout in ("context", "heads_tp"):
            cfg = dataclasses.replace(get_config(arch), attn_layout=layout)
            jcfg = dataclasses.replace(jget(arch), attn_layout=layout)
            assert _cell_rules(cfg, mesh) == j_cell_rules(jcfg, mesh)


def test_partition_spec_type():
    spec = P(("data",), None, ("pod", "data"))
    assert isinstance(spec, tuple) and tuple(spec) == ("data", None, ("pod", "data"))
    assert P() == () and repr(P("a")) == "PartitionSpec('a',)"
    with pytest.raises(TypeError, match="not a PartitionSpec tree"):
        shd.named(SINGLE, {"a": ("data",)})


# ---------------------------------------------------------------------------
# Placements and meshes (fake process groups)
# ---------------------------------------------------------------------------


def test_named_placements_row_major_and_refusals():
    with fake_world(8, rank=5):
        mesh = make_compat_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
        assert tuple(mesh.get_coordinate()) == (1, 0, 1)
        sh = shd.NamedSharding(mesh, P(("pod", "data"), "model"))
        assert sh.placements == (Shard(0), Shard(0), Shard(1))
        assert shd.NamedSharding(mesh, P(None, ("pod", "data"))).placements == (
            Shard(1), Shard(1), Replicate())
        assert shd.NamedSharding(mesh, P()).placements == (Replicate(),) * 3
        tree = shd.named(mesh, {"a": P("model"), "b": [P(None, "data")]})
        assert tree["a"].placements == (Replicate(), Replicate(), Shard(0))
        assert tree["b"][0].placements == (Replicate(), Shard(1), Replicate())
        # ("pod", "data") shards rows in row-major order, as GSPMD: rank 5 at
        # (pod 1, data 0, model 1) holds row block 1 * 2 + 0 and column block 1.
        x = torch.arange(8 * 4).reshape(8, 4)
        local = shd.distribute(x, sh).to_local()
        assert torch.equal(local, x[4:6, 2:4])
        with pytest.raises(ValueError, match="not in the mesh's axis order"):
            shd.NamedSharding(mesh, P(("data", "pod")))
        with pytest.raises(ValueError, match="not a mesh axis"):
            shd.NamedSharding(mesh, P("fsdp"))
        with pytest.raises(ValueError, match="used twice"):
            shd.NamedSharding(mesh, P("data", "data"))
        with pytest.raises(ValueError, match="does not divide"):
            shd.distribute(torch.zeros(6, 4), sh)
        with pytest.raises(ValueError, match="does not divide"):
            sh.check((8, 3))
        with pytest.raises(ValueError, match="more entries"):
            sh.check((8,))
        assert shd.batch_size_divisor(mesh) == 4 and shd.batch_axes(mesh) == ("pod", "data")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_full_config_leaf_divides_on_the_production_mesh(arch):
    """Every full-config leaf divides by its mesh axes on (16, 16) and on
    (2, 16, 16) (GSPMD, and ``named``, refuse uneven shards)."""
    _need_reference()
    _, params = _reference_params(arch)
    specs = dict(flatten_paths(shd.param_specs(get_config(arch), params)))
    shapes = dict(flatten_paths(params))
    for multi_pod in (False, True):
        with fake_world(required_devices(multi_pod=multi_pod)):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            for path, spec in specs.items():
                shd.NamedSharding(mesh, spec).check(shapes[path].shape)


def test_production_mesh_and_required_devices():
    assert required_devices() == 256 and required_devices(multi_pod=True) == 512
    with fake_world(256, rank=17):
        mesh = make_production_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
        assert tuple(mesh.get_coordinate()) == (1, 1)
        assert shd.batch_size_divisor(mesh) == 16
        with pytest.raises(ValueError, match="needs a world of 512 ranks, not 256"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    with fake_world(512, rank=300):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16) and tuple(mesh.get_coordinate()) == (1, 2, 12)
        assert shd.batch_size_divisor(mesh) == 32
        with pytest.raises(ValueError, match="needs a world of 256 ranks, not 512"):
            make_production_mesh(device_type="cpu")


def test_constrain_places_by_rules_and_leaves_indivisible_dims():
    with fake_world(4, rank=3):
        mesh = make_compat_mesh((2, 2), ("data", "model"), device_type="cpu")
        with logical.logical_axis_rules(mesh):
            x = logical.constrain(torch.arange(4 * 6.0).reshape(4, 6), "batch", "seq")
            assert x.placements == (Shard(0), Shard(1))
            assert torch.equal(x.to_local(), torch.arange(24.0).reshape(4, 6)[2:, 3:])
            y = logical.constrain(torch.zeros(3, 6), "batch", "vocab")  # 3 rows: unsharded
            assert y.placements == (Replicate(), Shard(1))
            with pytest.raises(ValueError, match="2 axes for ndim 3"):
                logical.constrain(torch.zeros(2, 2, 2), "batch", None)
            with pytest.raises(ValueError, match="maps both"):
                logical.constrain(torch.zeros(4, 4), "seq", "vocab")
        assert logical.current() is None


def test_remat_recompute_keeps_the_rules_on_another_thread():
    """The backward pass of CUDA tensors runs on autograd's device thread:
    a remat layer's recomputation must see the forward's rules."""
    seen = []
    ctx = (object(), {"batch": "data"})

    def layer(x):
        seen.append(logical.current())
        return x * x   # saves x: the backward recomputes the layer

    x = torch.ones(3, requires_grad=True)
    with logical.restored(ctx):
        y = remat_call(True, layer, x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == [ctx, ctx] and torch.equal(x.grad, torch.full((3,), 2.0))


# The routed functional collectives (sharding.gloo_cuda) on a 4-rank gloo
# world, routed for CPU tensors here: each op's result, and DTensor's
# redistributions through them. argv: rank, FileStore path.
ROUTED_SCRIPT = textwrap.dedent(
    """
    import sys
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4,
                            timeout=timedelta(seconds=60))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import gloo_cuda
    F, gn = torch.ops._c10d_functional, dist.group.WORLD.group_name
    x = torch.arange(8.0) + rank
    want = {"ag": F.all_gather_into_tensor(x, 4, gn), "rs": F.reduce_scatter_tensor(x, "sum", 4, gn),
            "rsa": F.reduce_scatter_tensor(x, "avg", 4, gn), "ar": F.all_reduce(x, "sum", gn),
            "ara": F.all_reduce(x, "avg", gn), "a2a": F.all_to_all_single(x, [2] * 4, [2] * 4, gn)}
    want = {k: F.wait_tensor(v).clone() for k, v in want.items()}
    assert gloo_cuda._route("CPU") == gloo_cuda.ROUTED
    got = {"ag": F.all_gather_into_tensor(x, 4, gn), "rs": F.reduce_scatter_tensor(x, "sum", 4, gn),
           "rsa": F.reduce_scatter_tensor(x, "avg", 4, gn), "ar": F.all_reduce(x, "sum", gn),
           "ara": F.all_reduce(x, "avg", gn), "a2a": F.all_to_all_single(x, [2] * 4, [2] * 4, gn)}
    for k in want:
        assert torch.equal(F.wait_tensor(got[k]), want[k]), k
    mesh = make_host_mesh((2, 2), ("data", "model"))
    g = torch.arange(64.0).reshape(8, 8)
    for src, dst in [((Shard(0), Shard(1)), (Replicate(), Replicate())),
                     ((Shard(0), Shard(1)), (Shard(1), Shard(0))),
                     ((Partial(), Partial()), (Shard(0), Shard(1))),
                     ((Partial(), Partial()), (Replicate(), Replicate()))]:
        d = (DTensor.from_local(g / 4, mesh, src, run_check=False) if src[0].is_partial()
             else distribute_tensor(g, mesh, src, src_data_rank=None))
        assert torch.equal(d.redistribute(mesh, dst).full_tensor(), g), (src, dst)
    dist.destroy_process_group()
    """
)


def test_routed_collectives_equal_their_kernels(tmp_path):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, "-c", ROUTED_SCRIPT, str(r), str(store)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


# The routing is process-wide, so a mesh built on another backend in a
# process that routed must refuse the routed collectives, not run them
# through c10d. A fake 4-rank world here, routed for CPU tensors.
FAKE_AFTER_ROUTING = textwrap.dedent(
    """
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import gloo_cuda
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    assert gloo_cuda._route("CPU") == gloo_cuda.ROUTED
    mesh = make_host_mesh((2, 2), ("data", "model"))
    F, gn = torch.ops._c10d_functional, dist.group.WORLD.group_name
    calls = {"ag": lambda x: F.all_gather_into_tensor(x, 4, gn),
             "rs": lambda x: F.reduce_scatter_tensor(x, "sum", 4, gn),
             "ar": lambda x: F.all_reduce(x, "sum", gn),
             "a2a": lambda x: F.all_to_all_single(x, [2] * 4, [2] * 4, gn),
             "mesh": lambda x: distribute_tensor(x.reshape(2, 4), mesh, (Shard(0), Shard(1)),
                                                 src_data_rank=None)
                               .redistribute(mesh, (Replicate(), Replicate()))}
    for name, call in calls.items():
        try:
            call(torch.arange(8.0))
        except RuntimeError as e:
            assert "'fake' group cannot use them" in str(e), (name, e)
        else:
            raise AssertionError(name + " ran on a fake group through the routed collectives")
    dist.destroy_process_group()
    """
)


def test_routed_collectives_refuse_other_backends():
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", FAKE_AFTER_ROUTING], env=env, timeout=120,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert res.returncode == 0, res.stdout[-3000:]
