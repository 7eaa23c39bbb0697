"""Resource accounting for multiplier netlists (paper Table II); a copy of
``repro/core/area.py`` over the port's netlist."""

from __future__ import annotations

import math
from typing import Dict

from .netlist import Netlist


def resources(netlist: Netlist) -> Dict[str, int]:
    luts = netlist.lut_count()
    # alias LUTs (net renames, see mult4_baselines.build_acc_mult4) are free
    luts -= len(getattr(netlist, "alias_luts", ()))
    carry4 = netlist.carry4_count()
    # a 7-series slice holds 4 LUT6 + 1 CARRY4; slices is the binding resource
    slices = max(math.ceil(luts / 4), carry4)
    return {"luts": luts, "carry4": carry4, "slices_min": slices}
