"""Roofline terms of a dry-run cell, from ``launch.steps.lower_cell``'s count.

The port's counterpart of ``repro.launch.roofline``. Three terms per (arch ×
shape × mesh), in seconds, per device:

    compute    = flops / 989e12 FLOP/s                 (H100 SXM, bf16 dense)
    memory     = bytes / 3.35e12 B/s                   (HBM3)
    collective = Σ collective_bytes / 450e9 B/s         (NVLink 4, each way)

The constants are the H100 SXM data sheet's, where the reference has the
v5e's (197e12, 819e9 and an ICI link's 50e9). ``LINK_BW`` takes the place of
``ICI_BW``: an H100's collectives leave it over NVLink, 18 links of 25 GB/s
each way, so 450 GB/s is one device's share of a collective's traffic, as
one ICI link's 50 GB/s is in the reference's (lower-bound) model.

The counts come from running the program, not from an XLA compile
(``launch.cost``), and so differ from the reference's in kind:

* ``hlo_flops`` are the matmul-class ops that
  ``torch.utils.flop_counter.flop_registry`` prices. XLA also counts
  elementwise flops.
* ``hlo_bytes`` are unfused: each eager op reads its inputs and writes its
  outputs, where XLA counts a fused kernel's operands once.
* collective bytes are the output bytes of the collectives DTensor issues.

So ``hlo_flops`` / ``hlo_bytes`` are not the reference's numbers (the names
stay, for the reports' sake); ``model_flops`` (6·N·D) is.

Also reported: MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the
useful-compute ratio MODEL_FLOPS / (flops × chips).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.cost import COLLECTIVES, CostRecord

PEAK_FLOPS = 989e12      # bf16 dense per device (H100 SXM)
HBM_BW = 3.35e12         # bytes/s per device (HBM3)
LINK_BW = 450e9          # bytes/s per device over NVLink 4, each way

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "build_roofline", "collective_bytes",
           "cost_analysis_dict", "format_table", "model_flops"]


def cost_analysis_dict(record: CostRecord) -> dict:
    """The record's costs under the reference's ``cost_analysis`` keys."""
    return {"flops": record.flops, "bytes accessed": record.bytes_accessed}


def collective_bytes(record: CostRecord) -> dict[str, int]:
    """Bytes of every collective by the reference's five names."""
    return {c: int(record.coll_bytes.get(c, 0)) for c in COLLECTIVES}


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: dict[str, int]
    model_flops: float

    # The counts are the rank's own (launch.cost counts the local ops under
    # DTensor), so the terms below are per device: no ÷chips.
    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS (global) vs counted flops (per device × chips)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute-term / max-term: 1.0 = perfectly compute-bound."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, cell) -> float:
    """6·N·D with N = active params (MoE counts top-k experts only); decode
    cells use D = global_batch tokens (one step). N is counted over the
    reference-layout tree (``launch.steps.abstract_params``)."""
    from repro_torch.launch.steps import abstract_params

    total = 0
    expert_extra = 0
    for path, leaf in _iter_paths(abstract_params(cfg)):
        n = math.prod(leaf.shape)
        total += n
        if "moe/w_" in path:
            expert_extra += n
    if cfg.num_experts:
        active = total - expert_extra + expert_extra * (
            cfg.num_experts_per_tok / cfg.num_experts)
    else:
        active = total
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * cell.global_batch  # decode: one token per sequence


def _iter_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_paths(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def build_roofline(cfg, cell, mesh_name: str, chips: int, record: CostRecord) -> Roofline:
    return Roofline(
        arch=cfg.name,
        cell=cell.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=record.flops,
        hlo_bytes=record.bytes_accessed,
        coll_bytes=collective_bytes(record),
        model_flops=model_flops(cfg, cell),
    )


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':<16}{'cell':<13}{'mesh':<10}{'t_comp(ms)':>11}"
           f"{'t_mem(ms)':>11}{'t_coll(ms)':>11}{'bound':>11}"
           f"{'useful':>8}{'roofl%':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:<16}{r['cell']:<13}{r['mesh']:<10}"
            f"{r['t_compute_s']*1e3:>11.3f}{r['t_memory_s']*1e3:>11.3f}"
            f"{r['t_collective_s']*1e3:>11.3f}{r['bottleneck']:>11}"
            f"{r['useful_ratio']:>8.3f}{r['roofline_fraction']*100:>8.1f}")
    return "\n".join(lines)
