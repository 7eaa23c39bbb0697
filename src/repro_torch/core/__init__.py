"""Core: the paper's contribution -- exact 4-bit multiplier netlists, their
area/timing models -- and the int4 quantization stack built on top of them
(quantization, the quantized linear layer and quantization plans)."""

from .netlist import Carry4, Lut, Netlist, CONST0, CONST1  # noqa: F401
from .mult4_proposed import build_proposed_mult4  # noqa: F401
from .mult4_baselines import (  # noqa: F401
    PUBLISHED_ROWS,
    behavioral_mult4,
    build_acc_mult4,
    build_lm_mult4,
)
from .timing import ARTIX7_CALIBRATED, DelayModel, analyze  # noqa: F401
from .area import resources  # noqa: F401
