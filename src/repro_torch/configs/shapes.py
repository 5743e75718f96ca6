"""Assigned input-shape cells (shared by all LM archs).

Each shape names the step it lowers:
  train_4k     -> train_step      tokens [256, 4096]
  prefill_32k  -> prefill_step    tokens [32, 32768]
  decode_32k   -> decode_step     1 new token, KV cache len 32768, B=128
  long_500k    -> decode_step     1 new token, context 524288, B=1
                  (sub-quadratic archs only; skipped for full attention,
                  see DESIGN.md §Arch-applicability)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def cells_for(cfg):
    return [s for s in SHAPES if applicable(cfg, s)]
