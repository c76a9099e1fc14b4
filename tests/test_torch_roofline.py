"""The port's roofline (``repro_torch.launch.roofline``) and its counting
mode (``repro_torch.launch.cost``), on the CPU.

* The reference's term arithmetic, bottleneck, ``useful_ratio`` and
  ``roofline_fraction`` cases (``tests/test_roofline_parse.py``) with the
  port's H100 constants; ``test_constants_are_h100`` pins 989e12 / 3.35e12
  / 450e9 where ``test_constants_are_v5e`` pins the reference's v5e values
  (a stated difference).
* The counting mode on fake process groups (backend "fake", each world in a
  ``python -c`` child of its own): the rank's flops of a sharded matmul on
  (16, 16) are the local mm's, 2·128·256·4096, on the first call (when
  DTensor's sharding propagator runs the op on global shapes) and on the
  second (when its cache answers); the collective bytes of a hand-computed
  redistribution on (4, 2); bytes and memory of a plain op.
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

from repro_torch.launch.cost import measure  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    Roofline,
    format_table,
)

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_roofline_terms_and_bottleneck():
    r = Roofline(arch="x", cell="train_4k", mesh="single", chips=256,
                 hlo_flops=989e12 * 0.01,          # 10 ms compute
                 hlo_bytes=3.35e12 * 0.05,         # 50 ms memory
                 coll_bytes={"all-reduce": int(450e9 * 0.02)},  # 20 ms coll
                 model_flops=989e12 * 0.01 * 256 * 0.5)
    np.testing.assert_allclose(r.t_compute, 0.01)
    np.testing.assert_allclose(r.t_memory, 0.05)
    np.testing.assert_allclose(r.t_collective, 0.02)
    assert r.bottleneck == "memory"
    np.testing.assert_allclose(r.useful_ratio, 0.5)
    np.testing.assert_allclose(r.roofline_fraction, 0.2)
    d = r.to_dict()
    assert d["bottleneck"] == "memory"
    assert "memory" in format_table([d]).splitlines()[2]


@pytest.mark.parametrize("terms,bound,frac", [
    ((0.03, 0.01, 0.02), "compute", 1.0),
    ((0.01, 0.01, 0.04), "collective", 0.25),
    ((0.0, 0.0, 0.0), "compute", 0.0),
])
def test_bottleneck_and_fraction_cases(terms, bound, frac):
    tc, tm, tl = terms
    r = Roofline(arch="x", cell="c", mesh="m", chips=1, hlo_flops=PEAK_FLOPS * tc,
                 hlo_bytes=HBM_BW * tm, coll_bytes={"all-gather": int(LINK_BW * tl)},
                 model_flops=0.0)
    assert r.bottleneck == bound
    np.testing.assert_allclose(r.roofline_fraction, frac)
    assert r.useful_ratio == 0.0


def test_constants_are_h100():
    assert PEAK_FLOPS == 989e12
    assert HBM_BW == 3.35e12
    assert LINK_BW == 450e9


def test_plain_op_bytes_flops_and_memory():
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def fn(x, y):
        z = x @ y            # 2·64·32·16 flops; reads 8 KiB + 2 KiB, writes 4 KiB
        return z.t()         # a view: no bytes, no storage

    out, rec = measure(fn, a, b)
    assert rec.flops == 2 * 64 * 32 * 16
    assert rec.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert rec.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert rec.output_bytes == 4 * 64 * 16
    assert rec.peak_bytes == rec.argument_bytes + rec.output_bytes
    assert rec.temp_bytes == rec.output_bytes
    assert sum(rec.coll_bytes.values()) == 0
    assert torch.equal(out, (a @ b).t())


def test_freed_temporaries_leave_the_peak():
    x = torch.ones(1024)   # 4 KiB

    def fn(t):
        for _ in range(3):
            t = t * 2.0    # each result frees the one before
        return t

    _, rec = measure(fn, x)
    assert rec.peak_bytes == 3 * 4096        # the argument, one old and one new
    assert rec.output_bytes == 4096


FAKE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.cost import measure
    from repro_torch.sharding.partition import NamedSharding, P
    from repro_torch.launch.steps import _fake_shard
    from torch._subclasses.fake_tensor import FakeTensorMode

    case = sys.argv[1]
    out = {}
    if case == "matmul":
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = _fake_shard(torch.empty(2048, 4096), NamedSharding(mesh, P("data", None)))
            w = _fake_shard(torch.empty(4096, 4096), NamedSharding(mesh, P("model", None)))
            assert tuple(x.to_local().shape) == (128, 4096)
            assert tuple(w.to_local().shape) == (256, 4096)
            out["flops"] = [measure(lambda a, b: a @ b, x, w)[1].flops for _ in range(2)]
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = _fake_shard(torch.empty(64, 32), NamedSharding(mesh, P("data", "model")))
            _, rec = measure(lambda a: a.redistribute(mesh, [Replicate(), Replicate()]), x)
            out["coll"] = rec.coll_bytes
            y = _fake_shard(torch.empty(64, 32), NamedSharding(mesh, P(None, None)))
            _, rec = measure(lambda a: a.redistribute(mesh, [Shard(0), Replicate()]), y)
            out["slice"] = rec.coll_bytes
    print(json.dumps(out))
    """
)


def _fake(case: str) -> dict:
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", FAKE_SCRIPT, case], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_sharded_matmul_counts_the_rank_local_op_every_call():
    # x (2048, 4096) on [Shard(0), Replicate()], w (4096, 4096) on
    # [Replicate(), Shard(0)]: each rank multiplies its 128 rows by the
    # 256-row block of w its model coordinate holds (x's columns sliced to
    # match), so 2·128·256·4096, not the global 2·2048·4096·4096.
    assert _fake("matmul")["flops"] == [2 * 128 * 256 * 4096] * 2


def test_redistribution_collective_bytes():
    out = _fake("redistribute")
    # (64, 32) float32 on ("data", "model") → replicated: the model dim's
    # all-gather gives the rank (16, 32), then the data dim's (64, 32) —
    # 4·(16·32 + 64·32) bytes of all-gather output, nothing else.
    assert out["coll"] == {"all-gather": 4 * (16 * 32 + 64 * 32), "all-reduce": 0,
                           "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    # Replicate → Shard is a local slice: no collective.
    assert sum(out["slice"].values()) == 0
