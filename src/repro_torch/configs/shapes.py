"""Assigned input-shape sets and per-arch applicability.

Each LM-family cell is (seq_len, global_batch).  ``train_4k`` lowers
``train_step``; ``prefill_32k`` lowers the serving prefill; ``decode_32k`` and
``long_500k`` lower ``serve_step`` (one new token against a KV/state cache of
``seq_len``), NOT train_step.

A copy of ``repro.configs.shapes``.

Skip rules (recorded in DESIGN.md §4):
  * encoder-only archs (hubert) have no decode step -> skip decode shapes;
  * ``long_500k`` needs sub-quadratic attention -> runs only for ssm/hybrid
    archs (mamba2, hymba); pure full-attention archs skip it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Returns (applicable, reason_if_not)."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or (
            cfg.sliding_window > 0 and cfg.has_attention
        )
        if not sub_quadratic:
            return False, (
                "pure full-attention arch: 512k decode needs sub-quadratic "
                "attention / bounded state (see DESIGN.md §4)"
            )
    return True, ""


def applicable_shapes(cfg: ModelConfig):
    for s in SHAPES.values():
        ok, _ = shape_applicable(cfg, s)
        if ok:
            yield s
