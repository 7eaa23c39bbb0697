"""Static timing analysis for LUT/CARRY4 netlists (paper Table III); a copy
of ``repro/core/timing.py`` over the port's netlist.  The delays are the
FPGA model's (an Artix-7 calibration), not a measurement of any GPU.

Without Vivado's timer, critical-path delay is estimated
with a static timing model over the netlist graph using a 7-series-shaped
delay set.  The constants are calibrated ONCE against the paper's reported
breakdown for the proposed design (2.750 ns = 1.302 logic + 1.448 net,
Table III) and then held fixed for every design; the tests assert that the
paper's *orderings* (Proposed < LM < Acc) emerge from the model rather than
being hardcoded per-design.

Delay classes:
  * T_LUT       LUT input -> output (logic)
  * T_CYINIT    fabric CIN -> CO[0] through CYINIT mux (logic)
  * T_MUXCY     CO[i] -> CO[i+1] within a CARRY4 (logic)
  * T_CO_CIN    CO[3] -> next CARRY4 CIN over the dedicated link (logic)
  * T_XORCY     stage carry -> O[i] through XORCY (logic)
  * T_S_CO/T_S_O/T_DI_CO  S/DI pin -> CO/O of the same stage (logic)
  * T_NET_IN    primary input -> first cell (net)
  * T_NET       LUT output -> next cell input (net)
  * T_NET_SLICE LUT O6/O5 -> same-slice CARRY4 S/DI pin (dedicated, ~0)
  * T_NET_CO    CO[3] -> general fabric -> LUT input (net; the slow path the
                paper's chain-B trick avoids)
  * T_NET_OUT   final cell output -> product pin (net)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .netlist import CONST0, CONST1, Carry4, Lut, Netlist


@dataclasses.dataclass(frozen=True)
class DelayModel:
    T_LUT: float = 0.124
    T_CYINIT: float = 0.510
    T_MUXCY: float = 0.117
    T_CO_CIN: float = 0.003
    T_XORCY: float = 0.314
    T_S_CO: float = 0.150
    T_S_O: float = 0.150
    T_DI_CO: float = 0.220
    T_NET_IN: float = 0.448
    T_NET: float = 0.350
    T_NET_SLICE: float = 0.020
    T_NET_CO: float = 0.820
    T_NET_OUT: float = 0.650


ARTIX7_CALIBRATED = DelayModel()


@dataclasses.dataclass
class Arrival:
    """Arrival time with its logic/net decomposition along the max path."""

    t: float = 0.0
    logic: float = 0.0
    net: float = 0.0

    def plus(self, logic: float = 0.0, net: float = 0.0) -> "Arrival":
        return Arrival(self.t + logic + net, self.logic + logic, self.net + net)


def _max_arr(*arrs: Arrival) -> Arrival:
    return max(arrs, key=lambda a: a.t)


def analyze(netlist: Netlist, model: DelayModel = ARTIX7_CALIBRATED) -> Dict[str, object]:
    """Return CPD (ns), its logic/net split, and per-output arrivals."""
    arr: Dict[str, Arrival] = {s: Arrival() for s in netlist.inputs}
    co_signals = set()

    def edge(sig: str, slice_local: bool = False) -> Arrival:
        """Arrival of `sig` at a consuming pin, including the routing edge."""
        if sig in (CONST0, CONST1):
            return Arrival()
        a = arr[sig]
        if sig in co_signals:
            return a.plus(net=model.T_NET_CO)      # CO -> fabric (slow)
        if slice_local:
            return a.plus(net=model.T_NET_SLICE)   # O6->S / O5->DI dedicated
        if a.t == 0.0 and sig in netlist.inputs:
            return a.plus(net=model.T_NET_IN)
        return a.plus(net=model.T_NET)

    for cell in netlist.cells:
        if isinstance(cell, Lut):
            ins = [s for s in cell.inputs if s not in (CONST0, CONST1)]
            worst = _max_arr(*(edge(s) for s in ins)) if ins else Arrival()
            out = worst.plus(logic=model.T_LUT)
            arr[cell.out_o6] = out
            if cell.is_dual:
                arr[cell.out_o5] = out
        elif isinstance(cell, Carry4):
            if cell.cin in (CONST0, CONST1):
                c = Arrival()
            elif cell.cin_dedicated:
                c = arr[cell.cin].plus(logic=model.T_CO_CIN)
            else:
                c = edge(cell.cin).plus(logic=model.T_CYINIT - model.T_MUXCY)
            for i in range(4):
                s_a = (edge(cell.s[i], slice_local=True)
                       if cell.s[i] not in (CONST0, CONST1) else Arrival())
                d_a = (edge(cell.di[i], slice_local=True)
                       if cell.di[i] not in (CONST0, CONST1) else Arrival())
                o_i = _max_arr(c.plus(logic=model.T_XORCY), s_a.plus(logic=model.T_S_O))
                c = _max_arr(
                    c.plus(logic=model.T_MUXCY),
                    s_a.plus(logic=model.T_S_CO),
                    d_a.plus(logic=model.T_DI_CO),
                )
                if cell.o_out[i] is not None:
                    arr[cell.o_out[i]] = o_i
                if cell.co_out[i] is not None:
                    arr[cell.co_out[i]] = c
                    co_signals.add(cell.co_out[i])
        else:
            raise TypeError(type(cell))

    outs = {s: arr[s].plus(net=model.T_NET_OUT) for s in netlist.outputs}
    crit_sig, crit = max(outs.items(), key=lambda kv: kv[1].t)
    return {
        "cpd": round(crit.t, 3),
        "logic": round(crit.logic, 3),
        "net": round(crit.net, 3),
        "critical_output": crit_sig,
        "arrivals": {k: round(v.t, 3) for k, v in outs.items()},
    }


def pipeline_stage_cpds(
    netlist: Netlist,
    register_after: Tuple[str, ...],
    model: DelayModel = ARTIX7_CALIBRATED,
    t_reg: float = 0.10,
) -> Dict[str, float]:
    """Two-stage pipelined CPD (paper §VI): registers after `register_after`.

    Stage 1 = inputs -> registered signals; stage 2 = registers -> outputs.
    Returns per-stage CPDs and the achievable Fmax.
    """
    full = analyze(netlist, model)
    arr: Dict[str, float] = {}
    # Stage 1: longest arrival among registered signals (re-run analyze and read)
    res = _arrivals_all(netlist, model)
    s1 = max(res[s].t for s in register_after) + t_reg
    # Stage 2: re-time with registered signals as fresh inputs (t=0).
    cut = set(register_after)
    res2 = _arrivals_all(netlist, model, zero_set=cut)
    s2 = max(res2[s].t for s in netlist.outputs) + model.T_NET_OUT + t_reg
    stage = max(s1, s2)
    return {
        "stage1_ns": round(s1, 3),
        "stage2_ns": round(s2, 3),
        "fmax_mhz": round(1e3 / stage, 1),
        "unpipelined_fmax_mhz": round(1e3 / full["cpd"], 1),
    }


def _arrivals_all(netlist, model, zero_set=frozenset()):
    """Full arrival map; signals in `zero_set` restart at t=0 (register cut)."""
    arr: Dict[str, Arrival] = {s: Arrival() for s in netlist.inputs}
    co_signals = set()

    def edge(sig, slice_local=False):
        if sig in (CONST0, CONST1):
            return Arrival()
        a = arr[sig]
        if sig in co_signals:
            return a.plus(net=model.T_NET_CO)
        if slice_local:
            return a.plus(net=model.T_NET_SLICE)
        if a.t == 0.0 and sig in netlist.inputs:
            return a.plus(net=model.T_NET_IN)
        return a.plus(net=model.T_NET)

    for cell in netlist.cells:
        if isinstance(cell, Lut):
            ins = [s for s in cell.inputs if s not in (CONST0, CONST1)]
            worst = _max_arr(*(edge(s) for s in ins)) if ins else Arrival()
            out = worst.plus(logic=model.T_LUT)
            for o in ([cell.out_o6] + ([cell.out_o5] if cell.is_dual else [])):
                arr[o] = Arrival() if o in zero_set else out
        elif isinstance(cell, Carry4):
            if cell.cin in (CONST0, CONST1):
                c = Arrival()
            elif cell.cin_dedicated:
                c = arr[cell.cin].plus(logic=model.T_CO_CIN)
            else:
                c = edge(cell.cin).plus(logic=model.T_CYINIT - model.T_MUXCY)
            for i in range(4):
                s_a = (edge(cell.s[i], slice_local=True)
                       if cell.s[i] not in (CONST0, CONST1) else Arrival())
                d_a = (edge(cell.di[i], slice_local=True)
                       if cell.di[i] not in (CONST0, CONST1) else Arrival())
                o_i = _max_arr(c.plus(logic=model.T_XORCY), s_a.plus(logic=model.T_S_O))
                c = _max_arr(
                    c.plus(logic=model.T_MUXCY),
                    s_a.plus(logic=model.T_S_CO),
                    d_a.plus(logic=model.T_DI_CO),
                )
                if cell.o_out[i] is not None:
                    arr[cell.o_out[i]] = Arrival() if cell.o_out[i] in zero_set else o_i
                if cell.co_out[i] is not None:
                    arr[cell.co_out[i]] = Arrival() if cell.co_out[i] in zero_set else c
                    co_signals.add(cell.co_out[i])
    return arr
