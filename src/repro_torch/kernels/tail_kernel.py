"""f1–f13 of the Haralick features for Hopper, beside their plain PyTorch
version.

``haralick_tail``
    (N, L, L) int32 GLCM counts → (N, 13) float64 features f1–f13 and, with
    ``with_p``, the normalized float64 P (N, L, L) and its marginals px, py
    (N, L) that f14's eigensolver (``mcc_kernel.second_eigenvalue``) reads,
    for 2 ≤ L ≤ ``MAX_LEVELS``
    (CUDA source: ``csrc/haralick_tail.cu``; plain version:
    ``haralick_tail_plain``)

It replaces no TPU kernel: the reference computes the features with jnp
(``repro/core/haralick.py``), and the plain version does the same with
PyTorch, ``f1_to_f13``: about 140 elementwise, reduce and ``index_add_``
launches on float64 copies of every matrix, each a pass over device memory
and a dispatch on the host. The kernel reads each matrix's counts once and
keeps P on chip: up to L = ``WARP_LEVELS`` one warp a matrix in shared
memory, wider one block a matrix making passes over the counts in L2. What
bounds it is the bytes: the counts in, the features out and, with f14, P
out (the source says how its design answers that).

The arithmetic is the plain version's, step by step. ``float32_step``
chooses how counts become P: False, as ``core.haralick`` normalizes counts
(``p = c / max(Σc, 1e-12)`` in float64, Σc exact); True, after the plan's
float32 normalization (``p32 = c / max(Σc, 1)`` in float32, then
``p = p32 / max(Σp32, 1e-12)`` in float64). Σc is an exact integer sum in
both: the plan's float32 sum of the counts is the same below 2²⁴.

As in ``glcm_kernel``, the wrapper checks its arguments and dispatches on
the device of the tensor it was given through ``build.dispatch``: on the CPU
it computes the plain version (in the analyzer's ``kernel:haralick_tail``
scope); on a CUDA tensor it launches the kernel, or raises — it never falls
back. ``build.launch`` raises ``haralick_tail.launches`` by one at each
launch.

``route`` decides, from the device type and L alone, what computes the
features of int32 counts: f1–f13 on this kernel or its plain version, f14
on ``mcc_kernel``'s eigensolver or the chunked eigvalsh.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Callable

import torch

from repro_torch.kernels import build
from repro_torch.kernels import mcc_kernel as _mcc

__all__ = ["haralick_tail", "haralick_tail_plain", "f1_to_f13", "route", "Route", "N_FEATURES",
           "MAX_LEVELS", "WARP_LEVELS"]

N_FEATURES = 13  # f1–f13, in core.haralick.FEATURE_NAMES' order
WARP_LEVELS = 32  # one warp lane a row (kMax in csrc/haralick_tail.cu)
MAX_LEVELS = 1024  # one block a matrix (kWideMax)

_EPS = 1e-12

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _entropy(p: torch.Tensor, dim) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + _EPS), dim=dim)


def f1_to_f13(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, L, L) normalized float64 GLCMs → (N, 13) features f1–f13 and the
    marginals px (over j), py (over i), each (N, L)."""
    n, L = p.shape[0], p.shape[-1]
    i = torch.arange(L, dtype=p.dtype, device=p.device)
    ii, jj = i[:, None], i[None, :]
    both = (-2, -1)

    px = p.sum(dim=2)  # (N, L) marginal over j
    py = p.sum(dim=1)  # (N, L) marginal over i
    mu_x = (i * px).sum(dim=1)
    mu_y = (i * py).sum(dim=1)
    sd_x = torch.sqrt(((i - mu_x[:, None]) ** 2 * px).sum(dim=1).clamp_min(0.0))
    sd_y = torch.sqrt(((i - mu_y[:, None]) ** 2 * py).sum(dim=1).clamp_min(0.0))

    # p_{x+y}(k), k = 0..2L-2  and  p_{x-y}(k), k = 0..L-1
    ii_i = torch.arange(L, device=p.device)
    sum_idx = (ii_i[:, None] + ii_i[None, :]).reshape(-1)
    diff_idx = (ii_i[:, None] - ii_i[None, :]).abs().reshape(-1)
    flat = p.reshape(n, L * L)
    p_sum = torch.zeros(n, 2 * L - 1, dtype=p.dtype, device=p.device)
    p_sum.index_add_(1, sum_idx, flat)
    p_diff = torch.zeros(n, L, dtype=p.dtype, device=p.device)
    p_diff.index_add_(1, diff_idx, flat)

    f1 = (p**2).sum(dim=both)
    f2 = ((ii - jj) ** 2 * p).sum(dim=both)
    f3 = ((ii * jj * p).sum(dim=both) - mu_x * mu_y) / (sd_x * sd_y).clamp_min(_EPS)
    # A marginal that sits on one level has no variance, and f3 is 0/0: its
    # numerator is then cancellation noise (~1e-14) over the 1e-12 guard, a
    # value of up to ~0.1 that depends on the order of summation (CPU and
    # card disagree). The pairwise variance ½·Σ_ik (i-k)² p_i p_k is exactly
    # 0 for such a marginal (every term holds a zero factor), so those
    # matrices get f3 = 0 — the value of the exact numerator over the guard.
    d2 = (ii - jj) ** 2
    spread_x = ((px @ d2) * px).sum(dim=1) > 0
    spread_y = ((py @ d2) * py).sum(dim=1) > 0
    f3 = torch.where(spread_x & spread_y, f3, torch.zeros_like(f3))
    mu = (p * ii).sum(dim=both)  # Haralick's μ in f4 (mean of joint over i)
    f4 = ((ii - mu[:, None, None]) ** 2 * p).sum(dim=both)
    f5 = (p / (1.0 + (ii - jj) ** 2)).sum(dim=both)
    ks = torch.arange(2 * L - 1, dtype=p.dtype, device=p.device)
    f6 = (ks * p_sum).sum(dim=1)
    f8 = _entropy(p_sum, 1)
    f7 = ((ks - f6[:, None]) ** 2 * p_sum).sum(dim=1)
    f9 = _entropy(p, both)
    diff_mean = (i * p_diff).sum(dim=1)
    f10 = ((i - diff_mean[:, None]) ** 2 * p_diff).sum(dim=1)
    f11 = _entropy(p_diff, 1)

    # Information measures of correlation.
    hx = _entropy(px, 1)
    hy = _entropy(py, 1)
    hxy = f9
    pxy_outer = px[:, :, None] * py[:, None, :]
    hxy1 = -(p * torch.log(pxy_outer + _EPS)).sum(dim=both)
    hxy2 = -(pxy_outer * torch.log(pxy_outer + _EPS)).sum(dim=both)
    f12 = (hxy - hxy1) / torch.maximum(hx, hy).clamp_min(_EPS)
    f13 = torch.sqrt((1.0 - torch.exp(-2.0 * (hxy2 - hxy))).clamp_min(0.0))

    feats = torch.stack([f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11, f12, f13], dim=-1)
    return feats, px, py


def _probabilities(counts: torch.Tensor, float32_step: bool) -> torch.Tensor:
    """Counts → float64 P, as the tail makes it (see the module's note)."""
    total = counts.sum(dim=(-2, -1), keepdim=True, dtype=torch.int64)
    if float32_step:
        p = (counts.to(torch.float32) / total.clamp_min(1).to(torch.float32)).to(torch.float64)
        return p / p.sum(dim=(-2, -1), keepdim=True).clamp_min(_EPS)
    return counts.to(torch.float64) / total.to(torch.float64).clamp_min(_EPS)


def haralick_tail_plain(counts: torch.Tensor, *, float32_step: bool = False,
                        with_p: bool = False):
    """Plain version of ``haralick_tail``, for any L: P from the counts,
    then ``f1_to_f13``. Returns (features, P, px, py), the last three None
    without ``with_p``."""
    p = _probabilities(counts, float32_step)
    feats, px, py = f1_to_f13(p)
    return (feats, p, px, py) if with_p else (feats, None, None, None)


def haralick_tail(counts: torch.Tensor, *, float32_step: bool = False, with_p: bool = False):
    """f1–f13 of each of the N matrices of ``counts`` (N, L, L), in one
    launch on the card. Returns (features (N, 13), P (N, L, L), px (N, L),
    py (N, L)), all float64, the last three None without ``with_p``.

    ``counts`` must be contiguous int32 with 2 ≤ L ≤ ``MAX_LEVELS``, on
    either device; anything else raises. On the card the result is the plain
    version's to float64 rounding (f13, ``sqrt(1 − exp(−2δ))``, magnifies
    the rounding of δ where δ is small).
    """
    if counts.ndim != 3 or counts.shape[1] != counts.shape[2]:
        raise ValueError(f"expected (N, L, L) counts, got shape {tuple(counts.shape)}")
    L = counts.shape[-1]
    if not 2 <= L <= MAX_LEVELS:
        raise ValueError(f"haralick_tail takes 2 <= L <= {MAX_LEVELS}, got {L}")
    if counts.dtype != torch.int32:
        raise ValueError(f"haralick_tail: counts must be int32, got {counts.dtype}")
    if not counts.is_contiguous():
        raise ValueError("haralick_tail: counts must be contiguous")
    return build.dispatch(
        haralick_tail, counts,
        lambda: haralick_tail_plain(counts, float32_step=float32_step, with_p=with_p),
        lambda: _launch(counts, float32_step, with_p))


haralick_tail.launches = 0


def _launch(counts: torch.Tensor, float32_step: bool, with_p: bool):
    n, L = counts.shape[0], counts.shape[-1]
    f64 = dict(dtype=torch.float64, device=counts.device)
    feats = torch.empty((n, N_FEATURES), **f64)
    p = px = py = None
    if with_p:
        p, px, py = torch.empty((n, L, L), **f64), torch.empty((n, L), **f64), torch.empty((n, L), **f64)
    if n == 0:  # a zero-block grid is an invalid launch
        return feats, p, px, py
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    build.launch(haralick_tail, "haralick_tail_launch", [_P, _P, _P, _P, _P, _LL, _I, _I, _P],
                 counts.device, counts.data_ptr(), feats.data_ptr(), ptr(p), ptr(px), ptr(py),
                 n, L, int(float32_step))
    return feats, p, px, py


@dataclasses.dataclass(frozen=True)
class Route:
    """What computes the features of int32 counts of one L on one device
    type: ``tail`` (f1–f13) "kernel" or "plain", ``solver`` (f14) "kernel"
    or "eigvalsh", and the functions that do: ``tail_fn`` and ``f14_fn``,
    the wrappers within their kernels' range of L (on the CPU they run
    their plain versions), the plain versions past it."""

    levels: int
    tail: str
    solver: str
    tail_fn: Callable
    f14_fn: Callable

    def chunks(self, n: int) -> int:
        """The eigvalsh calls f14 makes for ``n`` matrices: none on the
        kernel."""
        return 0 if self.solver == "kernel" else _mcc.eigvalsh_chunks(n, self.levels)


def route(device_type: str, levels: int) -> Route:
    """The route of the features of (N, L, L) int32 counts on ``device_type``
    ("cpu" or "cuda") for L = ``levels``: each kernel on the card within its
    range of L (2 ≤ L ≤ its ``MAX_LEVELS``), the plain versions elsewhere."""
    tail = 2 <= levels <= MAX_LEVELS
    f14 = 2 <= levels <= _mcc.MAX_LEVELS
    card = device_type == "cuda"
    return Route(
        levels=levels,
        tail="kernel" if card and tail else "plain",
        solver="kernel" if card and f14 else "eigvalsh",
        tail_fn=haralick_tail if tail else haralick_tail_plain,
        f14_fn=_mcc.second_eigenvalue if f14 else _mcc.second_eigenvalue_plain,
    )
