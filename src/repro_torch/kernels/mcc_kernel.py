"""f14's eigensolver for Hopper, beside its plain PyTorch version.

``second_eigenvalue``
    (N, L, L) normalized float64 GLCMs P with their marginals px, py (N, L)
    → (N,) float64: the second-largest eigenvalue of G = A Aᵀ,
    A = P / √(px·py), whose square root is Haralick's f14 (the maximal
    correlation coefficient), for 2 ≤ L ≤ ``MAX_LEVELS``
    (CUDA source: ``csrc/haralick_mcc.cu``; plain version:
    ``second_eigenvalue_plain``)

It replaces no TPU kernel: the reference solves f14 with
``jnp.linalg.eigvalsh`` (``repro/core/haralick.py``), and the plain version
does the same with ``torch.linalg.eigvalsh``, which on the card is
cuSOLVER's batched solver for every eigenvalue. The kernels compute the
one eigenvalue f14 needs: up to L = ``WARP_LEVELS`` one warp a matrix,
with A and G kept on chip; wider, one block a matrix on G, which the
wrapper forms with a float64 GEMM, as the plain version does.

As in ``glcm_kernel``, the wrapper checks its arguments and dispatches on
the device of the tensor it was given through ``build.dispatch``: on the CPU
it computes the plain version (in the analyzer's
``kernel:second_eigenvalue`` scope); on a CUDA tensor it launches the
kernel, or raises — it never falls back. ``build.launch`` raises
``second_eigenvalue.launches`` by one at each launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["second_eigenvalue", "second_eigenvalue_plain", "eigvalsh_chunks", "EIG_CHUNK_ELEMENTS",
           "MAX_LEVELS", "WARP_LEVELS"]

WARP_LEVELS = 32  # one warp lane a row (kMax in csrc/haralick_mcc.cu)
MAX_LEVELS = 1024  # one block of 1024 threads a matrix (kWideMax)

# Matrix elements per eigvalsh call of the plain version. cuSOLVER's batched
# symmetric eigensolver refuses a batch as large as a texture map's (260 100
# float64 32 x 32 matrices: CUSOLVER_STATUS_INVALID_VALUE from its
# buffer-size query), so the batch is solved in chunks of at most this many
# elements (128 MiB).
EIG_CHUNK_ELEMENTS = 1 << 24

_EPS = 1e-12  # core.haralick's clamp of the marginals

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def second_eigenvalue_plain(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Plain version of ``second_eigenvalue``, for any L ≥ 2: A, the
    Gram matrix ``A @ Aᵀ`` and ``eigvalsh(·)[:, -2]`` over chunks of at most
    ``EIG_CHUNK_ELEMENTS`` elements."""
    return torch.cat(  # second-largest eigenvalue (eigvalsh ascends)
        [torch.linalg.eigvalsh(g)[:, -2] for g in _gram(p, px, py).split(_chunk(p.shape[-1]))]
    )


def _gram(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """G = A Aᵀ, A = P / √(px·py) with px, py clamped at 1e-12."""
    a_mat = p / torch.sqrt(px[:, :, None].clamp_min(_EPS) * py[:, None, :].clamp_min(_EPS))
    return a_mat @ a_mat.transpose(-1, -2)


def _chunk(levels: int) -> int:
    """Matrices of L = ``levels`` an eigvalsh call of the plain version takes."""
    return max(1, EIG_CHUNK_ELEMENTS // (levels * levels))


def eigvalsh_chunks(n: int, levels: int) -> int:
    """The eigvalsh calls ``second_eigenvalue_plain`` makes for ``n``
    matrices of L = ``levels``: on the card, the host's waits on it."""
    return -(-n // _chunk(levels))


def second_eigenvalue(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """λ₂ of A Aᵀ, A = P / √(px·py) with px, py clamped at 1e-12, for
    each of the N matrices of ``p`` (N, L, L), in one launch on the card.

    The card takes contiguous float64 ``p``, ``px`` and ``py`` of shapes
    (N, L, L), (N, L), (N, L) with 2 ≤ L ≤ ``MAX_LEVELS``, and raises on
    anything else; the result is exact to float64 rounding. Past
    ``WARP_LEVELS`` it also allocates G, N L² doubles.
    """
    if p.ndim != 3 or p.shape[1] != p.shape[2]:
        raise ValueError(f"expected (N, L, L) matrices, got shape {tuple(p.shape)}")
    n, L = p.shape[0], p.shape[-1]
    if tuple(px.shape) != (n, L) or tuple(py.shape) != (n, L):
        raise ValueError(
            f"marginals must be (N, L) = {(n, L)}, got {tuple(px.shape)} and {tuple(py.shape)}"
        )
    return build.dispatch(second_eigenvalue, p, lambda: second_eigenvalue_plain(p, px, py),
                          lambda: _launch(p, px, py))


second_eigenvalue.launches = 0


def _launch(p, px, py) -> torch.Tensor:
    n, L = p.shape[0], p.shape[-1]
    if not 2 <= L <= MAX_LEVELS:
        raise ValueError(f"second_eigenvalue on the card takes 2 <= L <= {MAX_LEVELS}, got {L}")
    for name, t in (("p", p), ("px", px), ("py", py)):
        if t.dtype != torch.float64:
            raise ValueError(f"second_eigenvalue: {name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"second_eigenvalue: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"second_eigenvalue: {name} on {t.device}, p on {p.device}")
    out = torch.empty((n,), dtype=torch.float64, device=p.device)
    if n == 0:  # a zero-block grid is an invalid launch
        return out
    if L <= WARP_LEVELS:
        build.launch(second_eigenvalue, "haralick_mcc_launch", [_P, _P, _P, _P, _LL, _I, _P],
                     p.device, p.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), n, L)
    else:  # the kernel reduces G in place
        gram = _gram(p, px, py).contiguous()
        build.launch(second_eigenvalue, "haralick_mcc_wide_launch", [_P, _P, _LL, _I, _P],
                     p.device, gram.data_ptr(), out.data_ptr(), n, L)
    return out
