"""The port's cells (``repro_torch.launch.steps``) against the reference's
(``repro.launch.steps``), every arch at its published config, on the CPU.

* ``abstract_params``: the reference-layout tree of a ``meta`` model has the
  paths, shapes and dtypes of the reference's ``jax.eval_shape(api.init)``;
* ``roofline.model_flops``: equal to the reference's exactly, for every arch
  × applicable shape;
* ``build_cell`` on a (4, 2) ("data", "model") mesh, every arch × applicable
  shape: each program's in/out specs and ``donate_argnums`` equal the
  reference's ``build_cell`` (which only runs ``eval_shape``), with one
  stated difference: a ``grad_accum > 1`` train cell takes its batch split
  into microbatches, ``(accum, B/accum, T)`` on ``P(None, *spec)`` where the
  reference takes ``(B, T)`` on ``spec``. The reference runs in a child with
  8 forced host devices, the port in a child on a fake 8-rank world.
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
jax = pytest.importorskip("jax")

from repro.configs import ARCHS, SHAPES, applicable  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch.steps import abstract_params as jabstract  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models.convert import flatten_paths  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
CELLS = [(a, s) for a in ARCHS for s in SHAPES if applicable(jget(a), SHAPES[s])]

# Both children print {"arch|shape": {"in": ..., "out": ..., "donate": ...}},
# a spec as a list of entries (None, a name, or a list of names; trailing
# Nones dropped), a tree as nested dicts / lists.
SPEC_JSON = textwrap.dedent(
    """
    def spec_json(s):
        out = [list(e) if isinstance(e, tuple) and len(e) > 1 else
               (e[0] if isinstance(e, tuple) else e) for e in tuple(s)]
        while out and out[-1] is None:
            out.pop()
        return out

    def tree_json(t):   # an empty subtree (a norm without parameters) holds no spec
        if isinstance(t, dict):
            return {str(k): tree_json(v) for k, v in t.items() if v != {}}
        if isinstance(t, (list, tuple)):
            return [tree_json(v) for v in t]
        return spec_json(t.spec)
    """
)

REF = SPEC_JSON + textwrap.dedent(
    """
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import ARCHS, SHAPES, applicable, get_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_cell

    mesh = make_host_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, cell in SHAPES.items():
            if not applicable(cfg, cell):
                continue
            prog = build_cell(cfg, cell, mesh)
            out[f"{arch}|{shape}"] = {"in": tree_json(prog.in_shardings),
                                      "out": tree_json(prog.out_shardings),
                                      "donate": list(prog.donate_argnums),
                                      "accum": max(cfg.grad_accum, 1)}
    print(json.dumps(out))
    """
)

PORT = SPEC_JSON + textwrap.dedent(
    """
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    mesh = make_host_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, cell in SHAPES.items():
            if not applicable(cfg, cell):
                continue
            prog = build_cell(cfg, cell, mesh)
            out[f"{arch}|{shape}"] = {"in": tree_json(prog.in_shardings),
                                      "out": tree_json(prog.out_shardings),
                                      "donate": list(prog.donate_argnums)}
    print(json.dumps(out))
    """
)


def _child(script: str, env_extra: dict) -> dict:
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1", **env_extra}
    r = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env)
    return r


@pytest.fixture(scope="module")
def specs():
    """Both packages' specs of every cell, the two children run together."""
    ref = _child(REF, {"JAX_PLATFORMS": "cpu"})
    port = _child(PORT, {})
    out = {}
    for name, p in (("ref", ref), ("port", port)):
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}:\n{stderr[-4000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch):
    want = dict(flatten_paths(jax.tree.map(lambda s: s, jabstract(jget(arch)))))
    got = dict(flatten_paths(abstract_params(get_config(arch))))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, path


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference_exactly(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    for shape, cell in SHAPES.items():
        if applicable(jcfg, cell):
            assert rl.model_flops(cfg, cell) == jrl.model_flops(jcfg, cell), (arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_specs_equal_reference(specs, arch, shape):
    key = f"{arch}|{shape}"
    ref, port = specs["ref"][key], specs["port"][key]
    assert port["donate"] == ref["donate"]
    assert port["out"] == ref["out"]
    want_in = ref["in"]
    if shape == "train_4k" and ref["accum"] > 1:   # the stated difference: split batch
        want_in = [*want_in[:-1], {k: [None, *v] for k, v in want_in[-1].items()}]
    assert port["in"] == want_in
    assert len(specs["port"]) == len(CELLS)
