"""Assigned input-shape suites and (arch x shape) applicability.

Each LM arch is paired with four shapes (see the assignment):

    train_4k     seq_len=4096   global_batch=256   -> lowers train_step
    prefill_32k  seq_len=32768  global_batch=32    -> lowers prefill_step
    decode_32k   seq_len=32768  global_batch=128   -> lowers serve_step
                 (one new token against a KV cache of seq_len)
    long_500k    seq_len=524288 global_batch=1     -> lowers serve_step
                 (requires sub-quadratic attention)

Applicability rules (documented in DESIGN.md §Shape-applicability):
  * long_500k runs only for SSM / hybrid / sliding-window archs.
  * whisper-base's decoder context is architecturally capped (learned positions,
    30s audio); its 32k/500k cells are recorded as SKIP with reason.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

#: archs allowed to run the 500k decode cell (sub-quadratic token mixing).
SUBQUADRATIC_ARCHS = frozenset({"mamba2-780m", "zamba2-1.2b", "h2o-danube-1.8b"})


def applicability(config: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Return None if the cell runs, else a SKIP reason string."""
    if shape.name == "long_500k":
        if config.name not in SUBQUADRATIC_ARCHS:
            return (
                "full quadratic attention: 524288-token KV cache is out of scope "
                "for this family (see DESIGN.md); run sub-quadratic archs instead"
            )
    if config.is_encoder_decoder:
        if shape.seq_len > 8_192:
            return (
                "whisper decoder context is architecturally capped (learned "
                "positions / 30s audio); 32k+ KV cells do not exist for this arch"
            )
    return None


def cells(configs, shapes=SHAPES):
    """All (config, shape, skip_reason) cells in assignment order."""
    out = []
    for c in configs:
        for s in shapes:
            out.append((c, s, applicability(c, s)))
    return out
