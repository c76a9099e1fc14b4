"""The full 8-bit gray range on the port's normal path: L = 256 GLCMs of
uint8 stacks at distance 1 in four directions (scikit-image's
``graycomatrix(image, [1], [0, pi/4, pi/2, 3pi/4], levels=256)``), held to
the benchmark's plain reference; and the count's route and f14's solver as
the plan's spans record them.

The stacks are the benchmark's own seeded images (``h100_bench.data``):
smooth and random halves, each spanning 0..255.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import data  # noqa: E402
from h100_bench.reference import glcm as ref  # noqa: E402
from h100_bench.reference import expected_features  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import backends  # noqa: E402
from repro_torch.core.plan import compile_plan, plan_cache_clear  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.kernels import mcc_kernel  # noqa: E402
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402

CFG = json.loads((ROOT / "h100_bench/configs/graycomatrix-2d-4096-L256.json").read_text())
LIMIT = json.loads((ROOT / "h100_bench/workloads/features-4096-L256.json").read_text()
                   )["checks"]["feature_err"]
PAIRS = tuple(map(tuple, CFG["pairs"]))
L = CFG["levels"]


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True, capacity=4096)
    prev = set_tracer(tr)
    yield tr
    set_tracer(prev)


def _stack(size: int, seed: int) -> torch.Tensor:
    return data.images(4, size, seed, "cpu")  # smooth, random, smooth, random


def _features(x, **kw):
    return repro_torch.glcm_features(x, L, pairs=PAIRS, quantize="uniform", device="cpu", **kw)


def test_configuration_is_scikit_images_default():
    assert L == 256 and CFG["dtype"] == "uint8" and CFG["reduced"] == []
    assert PAIRS == ((1, 0), (1, 45), (1, 90), (1, 135))
    assert ref.offsets(PAIRS) == [(0, 1), (1, -1), (1, 0), (1, 1)]
    assert GLCMSpec(levels=L, pairs=PAIRS).offsets() == ((0, 1), (1, -1), (1, 0), (1, 1))


@pytest.mark.parametrize("size", [64, 128])
def test_uniform_binning_at_256_levels_is_the_identity(size):
    """Every image the benchmark makes spans 0..255, so binning over its own
    range at L = 256 gives back its bytes: the counts are graycomatrix's."""
    for img in _stack(size, 2**40 + 7):
        assert int(img.min()) == 0 and int(img.max()) == 255
        assert torch.equal(ref.bin_levels(img, L, *ref.image_range(img)), img.to(torch.int64))


@pytest.mark.parametrize("scheme", ["auto", "cuda_fused"])
@pytest.mark.parametrize("size,seed", [(64, 2**40 + 17), (128, 3)])
def test_counts_are_the_references_bit_for_bit(size, seed, scheme):
    x = _stack(size, seed)
    plan = compile_plan(GLCMSpec(levels=L, pairs=PAIRS, quantize="uniform", scheme=scheme),
                        tuple(x.shape), device="cpu")
    got = plan(x)
    assert got.dtype == torch.int32 and got.shape == (4, 4, L, L)
    for img, counts in zip(x, got):
        lv = ref.bin_levels(img, L, *ref.image_range(img))
        assert torch.equal(counts.to(torch.int64), ref.counts(lv, L, ref.offsets(PAIRS)))


@pytest.mark.parametrize("size,seed", [(64, 2**40 + 17), (128, 3)])
def test_features_are_the_references_within_the_cells_limit(size, seed):
    x = _stack(size, seed)
    got = _features(x).numpy().astype(np.float64)
    want = torch.stack([expected_features(img, CFG) for img in x]).numpy()
    scale = np.maximum(np.abs(want).reshape(-1, 14).max(axis=0), np.finfo(np.float64).tiny)
    err = float((np.abs(got - want) / scale).max())
    assert err <= LIMIT, err
    assert err < 1e-6  # float32 rounding of float64 features, far below the limit


def test_plan_count_and_eigvalsh_carry_their_route(tracer):
    """On the CPU the count is the plain version's (``hist`` "plain") and f14
    the chunked eigvalsh: one call at L = 256 for the 16 matrices."""
    _features(_stack(64, 5))
    count = [s for s in tracer.spans() if s.name == "plan.count"]
    eig = [s for s in tracer.spans() if s.name == "haralick.eigvalsh"]
    assert [s.attrs for s in count] == [{"hist": "plain", "copies": 0}]
    assert [s.attrs for s in eig] == [{"matrices": 16, "solver": "eigvalsh", "chunks": 1}]


def test_the_route_is_found_once_per_plan_and_never_untraced(monkeypatch, tracer):
    calls = []
    route = backends.count_route
    monkeypatch.setattr(backends, "count_route",
                        lambda *a, **kw: calls.append(a[1].shape) or route(*a, **kw))
    x = _stack(64, 6)
    plan_cache_clear()  # a plan found earlier keeps its route
    set_tracer(Tracer(enabled=False))
    untraced = _features(x)
    assert calls == []
    set_tracer(tracer)
    traced = [_features(x) for _ in range(3)]
    assert calls == [torch.Size([4, 64, 64])]
    assert len([s for s in tracer.spans() if s.name == "plan.count"]) == 3
    for out in traced:  # the tracer changes nothing of the output
        assert torch.equal(out, untraced)


def test_eigvalsh_chunks_counts_the_plain_versions_calls():
    per = mcc_kernel.EIG_CHUNK_ELEMENTS // (256 * 256)
    assert mcc_kernel.eigvalsh_chunks(32, 256) == 1
    assert mcc_kernel.eigvalsh_chunks(per, 256) == 1
    assert mcc_kernel.eigvalsh_chunks(per + 1, 256) == 2
    assert mcc_kernel.eigvalsh_chunks(0, 256) == 0
    assert mcc_kernel.eigvalsh_chunks(260_100, 32) == 16


def test_the_fused_kernels_route_is_its_launch_plans(monkeypatch):
    """``cuda_fused`` reads its launch plan's ``shared_hist``, ``copies``
    and ``cluster`` (a card gives them; here stand-ins do) for whole images:
    per-block shared sets, a cluster's shared memory, or global atomics; a
    texture map (the window kernel) and the other backends record
    no route."""
    seen = []
    plans = [({"shared_hist": 1, "copies": 4, "cluster": 0},
              {"hist": "shared", "copies": 4, "cluster": 0}),
             ({"shared_hist": 0, "copies": 1, "cluster": 8},
              {"hist": "cluster", "copies": 1, "cluster": 8}),
             ({"shared_hist": 0, "copies": 1, "cluster": 0},
              {"hist": "global", "copies": 1, "cluster": 0})]
    stand_in = {}

    def fake(kernel, shape, offsets, **kw):
        seen.append((kernel, shape, tuple(offsets), kw))
        return stand_in

    monkeypatch.setattr(backends, "launch_plan", fake)
    fused = backends.get_backend("cuda_fused")
    spec = GLCMSpec(levels=L, pairs=PAIRS, quantize="uniform", scheme="cuda_fused")
    for plan, route in plans:
        stand_in.clear()
        stand_in.update(plan)
        assert fused.route((8, 4096, 4096), spec, 2) == route
    assert seen == [("glcm_fused", (8, 4096, 4096), spec.offsets(),
                     dict(levels=L, split=8, copies=1, kind=2))] * len(plans)
    win = spec.replace(region="window", region_shape=32, region_stride=16)
    assert fused.route((1, 256, 256), win, 2) == {} and len(seen) == len(plans)
    assert all(backends.get_backend(n).route is None
               for n in backends.available_backends() if n != "cuda_fused")


@pytest.mark.cuda
@pytest.mark.parametrize("levels,pairs,hist", [(256, PAIRS, "cluster"),
                                               (32, ((1, 0), (1, 45), (4, 0), (4, 45)), "shared")])
def test_route_and_solver_on_card(tracer, levels, pairs, hist):
    """On the card: the L = 256 count (1 MB of counts: no block holds
    them) votes half the offsets into a cluster's shared memory and the
    rest with global atomics, and the paper's L = 32 into per-block shared
    sets; f14 takes a kernel at both widths, no eigvalsh call; the features
    are the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    x = data.images(8, 1024, 11, "cuda")
    cfg = {**CFG, "levels": levels, "pairs": [list(p) for p in pairs]}
    got = repro_torch.glcm_features(x, levels, pairs=pairs, quantize="uniform", device="cuda")
    count = [s for s in tracer.spans() if s.name == "plan.count"]
    eig = [s for s in tracer.spans() if s.name == "haralick.eigvalsh"]
    assert count[-1].attrs["hist"] == hist and count[-1].attrs["copies"] >= 1
    assert (count[-1].attrs["cluster"] >= 2) == (hist == "cluster")
    assert eig[-1].attrs == {"matrices": 8 * len(pairs), "solver": "kernel", "chunks": 0}
    want = torch.stack([expected_features(img, cfg) for img in x]).cpu().numpy()
    scale = np.maximum(np.abs(want).reshape(-1, 14).max(axis=0), np.finfo(np.float64).tiny)
    assert float((np.abs(got.cpu().numpy() - want) / scale).max()) <= LIMIT
