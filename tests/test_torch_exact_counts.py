"""Count-only results keep exact int32 counts past 2**24, on the CPU.

A constant 4097 x 4098 image at d = 1, theta = 0 puts 4097 * 4097 =
16 785 409 votes in one cell. float32 holds no odd integer past 2**24, so a
float32 copy of the counts (the reference's ``glcm()``) makes it 16 785 408.
The port keeps the kernels' int32 counts from the kernel to the caller:
``glcm()``, a count-only plan and the temporal stream's delta must each
return 16 785 409 exactly. The kernel backends run their plain versions
here (CPU tensors); "scatter" and "native" count in integers too. The
one-hot schemes vote in float32 by design (exact below 2**24) and are not
held to this.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.glcm import glcm  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402

H, W, LEVELS, LEVEL = 4097, 4098, 2, 1
VOTES = H * (W - 1)   # 16 785 409
INT_SCHEMES = ["scatter", "cuda", "cuda_fused", "native"]


@pytest.fixture(scope="module")
def image():
    return np.full((H, W), LEVEL, np.int32)


def test_the_cell_is_past_what_float32_holds():
    assert VOTES == 16_785_409 and VOTES > 2**24
    assert int(np.float32(VOTES)) == 16_785_408


@pytest.mark.parametrize("scheme", INT_SCHEMES)
def test_glcm_counts_past_2_24_exactly(image, scheme):
    got = glcm(image, LEVELS, d=1, theta=0, scheme=scheme, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (LEVELS, LEVELS)
    assert int(got[LEVEL, LEVEL]) == VOTES
    assert int(got.sum()) == VOTES


@pytest.mark.parametrize("scheme", ["cuda", "cuda_fused"])
def test_count_only_plan_past_2_24_exactly(image, scheme):
    spec = GLCMSpec(levels=LEVELS, pairs=((1, 0),), scheme=scheme)
    got = compile_plan(spec, (1, H, W), device="cpu")(image[None])
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 1, LEVELS, LEVELS)
    assert int(got[0, 0, LEVEL, LEVEL]) == VOTES
    # Normalized matrices stay float32: the counts widen where they divide.
    norm = compile_plan(spec.replace(normalize=True), (H, W), device="cpu")(image)
    assert norm.dtype == torch.float32 and float(norm[0, LEVEL, LEVEL]) == 1.0


def test_stream_delta_past_2_24_exactly(image):
    spec = GLCMSpec(levels=LEVELS, pairs=((1, 0),), scheme="cuda_fused")
    plan = compile_plan(spec, (H, W), device="cpu", temporal_window=2)
    frame = torch.from_numpy(image)
    state = plan.init_state()
    state, out = plan.update(state, frame)
    assert out.dtype == torch.int32
    assert int(state.counts[0, LEVEL, LEVEL]) == VOTES
    assert int(out[0, LEVEL, LEVEL]) == VOTES
    state, out = plan.update(state, frame)
    assert int(out[0, LEVEL, LEVEL]) == 2 * VOTES
