"""The assigned input-shape cells. Every architecture pairs with all four;
``long_500k`` applies only to sub-quadratic archs."""

from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable(cfg, cell: ShapeCell) -> bool:
    """Whether a (config, shape) cell is runnable."""
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


def smoke_cell(kind: Kind) -> ShapeCell:
    """Tiny shapes for CPU smoke tests."""
    return {
        "train": ShapeCell("smoke_train", "train", 32, 2),
        "prefill": ShapeCell("smoke_prefill", "prefill", 32, 2),
        "decode": ShapeCell("smoke_decode", "decode", 32, 2),
    }[kind]
