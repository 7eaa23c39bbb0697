"""Pipelined variant of the proposed multiplier (paper §VI); a copy of
``repro/core/pipeline_mult.py`` over the port's netlist.

Register boundary: after the first LUT level (P0..P2, C0, S1, S3 and the
Prop/Gen pairs) and before the carry chains.  Stage 1 therefore contains all
fabric logic; stage 2 contains only the CARRY4s, so the pipelined design
reaches a far higher Fmax at a latency of 2 cycles and II=1 -- exactly the
trade the paper motivates for multiplier arrays feeding accumulators.
"""

from __future__ import annotations

from typing import Dict

import torch

from .mult4_proposed import build_proposed_mult4
from .timing import ARTIX7_CALIBRATED, DelayModel, pipeline_stage_cpds

#: signals registered between stage 1 and stage 2
STAGE1_REGS = (
    "P0", "P1", "P2", "C0",
    "Prop0", "Gen0", "Prop1", "Gen1", "Prop2", "Gen2", "Prop3", "Gen3",
)


def pipelined_report(model: DelayModel = ARTIX7_CALIBRATED) -> Dict[str, float]:
    return pipeline_stage_cpds(build_proposed_mult4(), STAGE1_REGS, model)


def pipelined_mult4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Functional model (timing-transparent): identical results, 2-cycle latency."""
    return build_proposed_mult4()(a, b)
