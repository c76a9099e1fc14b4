"""Vote-conflict analysis — the paper's §II.A, as a measurement tool.

Counterpart of ``repro.core.conflicts``. The paper explains Table II by the
probability that concurrent threads vote the same GLCM bin. That
probability is a pure property of the image's pair distribution; this module
computes it so the Fig. 1(a)/(b) regimes become quantitative:

  * ``conflict_profile``: per-bin vote shares p_i = P_i / Σ P.
  * ``expected_collision_rate``: the probability two random concurrent
    votes target the same bin (Simpson index Σ p_i², which equals
    Haralick's *energy* of the GLCM: the formal reason 'smooth image ⇒ slow
    atomics' and 'high L ⇒ fast').
  * ``serialization_factor(n_threads)``: expected max queue length among
    n concurrent voters under multinomial voting — the paper's 'threads
    will be lining up' effect, E[max_i Binomial(n, p_i)] (upper-bounded).

On the card these are what the shared-memory atomics of the vote kernels
pay for; the tool predicts which inputs contend.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.plan import resolve_device
from repro_torch.core.schemes import glcm_onehot
from repro_torch.kernels.ref import glcm_offsets

__all__ = ["conflict_profile", "expected_collision_rate", "serialization_factor",
           "analyze_image"]


def conflict_profile(img, levels: int, d: int = 1, theta: int = 0, *,
                     device=None) -> torch.Tensor:
    """Vote shares of the (L·L,) bins of a quantized image's GLCM for one
    (d, theta) offset, on ``device`` (None: the card)."""
    x = torch.as_tensor(img, device=resolve_device(device))
    g = glcm_onehot(x, levels, glcm_offsets(d, theta))
    total = g.sum().clamp_min(1.0)
    return (g / total).reshape(-1)


def expected_collision_rate(p: torch.Tensor) -> torch.Tensor:
    """Simpson index Σ p_i² = P(two concurrent votes collide) = GLCM energy."""
    return torch.sum(p * p)


def serialization_factor(p: torch.Tensor, n_threads: int) -> torch.Tensor:
    """Upper bound on E[max_i Binomial(n, p_i)] (union bound + mean):
    max_i (n·p_i) + sqrt(2·n·p_max·log K) — the expected depth of the
    longest atomic queue among n concurrent voters."""
    pmax = torch.max(p)
    return n_threads * pmax + torch.sqrt(2.0 * n_threads * pmax * math.log(p.shape[0]))


def analyze_image(img, levels: int, d: int = 1, theta: int = 0, n_threads: int = 1024, *,
                  device=None) -> dict:
    p = conflict_profile(img, levels, d, theta, device=device)
    rate = expected_collision_rate(p)
    return {
        "collision_rate": float(rate),
        "energy": float(rate),  # identical — the paper's link to Haralick f1
        "max_bin_share": float(torch.max(p)),
        "serialization_factor": float(serialization_factor(p, n_threads)),
        "uniform_baseline": 1.0 / (levels * levels),
    }
