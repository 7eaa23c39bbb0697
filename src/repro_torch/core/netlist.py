"""Bit-exact simulation of Xilinx 7-series logic primitives (LUT6 / LUT6_2 /
CARRY4), the PyTorch port of ``repro/core/netlist.py``.

It models exactly the primitives Kida & Sato's 4-bit multiplier
instantiates (Section II / Fig. 1-2) and evaluates whole netlists either

  * ``mode="direct"``  -- each LUT's Boolean function evaluated symbolically
    (elementwise bit operations on torch ``uint8`` tensors), or
  * ``mode="init"``    -- each LUT evaluated by indexing its synthesized 64-bit
    INIT truth table, i.e. exactly what the FPGA hardware does.

Both modes run on the operands' device over arbitrarily shaped (broadcast)
bit tensors, so a netlist doubles as a vectorized "array of multipliers" --
the deployment scenario the paper targets (Section I); CUDA operands
compute on the card.

INIT semantics (matches Vivado's LUT6/LUT6_2 primitives):
  * LUT6:    O6 = INIT[ I5<<5 | I4<<4 | I3<<3 | I2<<2 | I1<<1 | I0 ]
  * LUT6_2:  O6 as above (I5 is tied to 1 in dual-output use, selecting the
             upper 32-bit half); O5 = INIT[ I4<<4 | ... | I0 ] (lower half).
Unused inputs are tied to logic '1' (paper, Table I caption).

INIT synthesis (``init_value``, ``init_table``) is pure Python and the JAX
package's, line for line.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

BoolFn = Callable[[Mapping[str, object]], object]

CONST0 = "0"
CONST1 = "1"


def _device(env: Dict[str, torch.Tensor]) -> torch.device:
    """The device the netlist's signals live on (the operands')."""
    return next(iter(env.values())).device


@dataclasses.dataclass(frozen=True)
class Lut:
    """A LUT6 (single output) or LUT6_2 (dual output, shared inputs).

    ``inputs`` are signal names in I0..I5 order; missing/extra positions are
    tied to '1' exactly as the paper does.  ``fn_o6``/``fn_o5`` map a dict of
    named input bits (ints 0/1 during INIT synthesis, uint8 tensors during
    evaluation) to the output bit.  For a LUT6_2 both are given and the pair
    must share <=5 real inputs (hardware constraint; checked).
    """

    name: str
    inputs: Sequence[str]           # length <= 6, signal names or "0"/"1"
    fn_o6: BoolFn
    out_o6: str
    fn_o5: Optional[BoolFn] = None
    out_o5: Optional[str] = None

    def __post_init__(self):
        real = [s for s in self.inputs if s not in (CONST0, CONST1)]
        if len(self.inputs) > 6:
            raise ValueError(f"{self.name}: >6 inputs")
        if self.is_dual and len(real) > 5:
            raise ValueError(
                f"{self.name}: LUT6_2 dual-output allows at most 5 shared real "
                f"inputs (I5 must be tied high); got {real}"
            )

    @property
    def is_dual(self) -> bool:
        return self.fn_o5 is not None

    @property
    def padded_inputs(self) -> List[str]:
        """Inputs padded to length 6 with tied-'1' (paper convention)."""
        pads = [CONST1] * (6 - len(self.inputs))
        return list(self.inputs) + pads

    # -- INIT synthesis ----------------------------------------------------
    def init_value(self) -> int:
        """Synthesize the 64-bit INIT word from the Boolean functions.

        For dual-output LUTs the upper 32 bits hold O6 (with I5=1) and the
        lower 32 bits hold O5, per the LUT6_2 primitive.
        """
        init = 0
        ins = self.padded_inputs
        for idx in range(64):
            bits = {}
            ok = True
            for pos, sig in enumerate(ins):
                b = (idx >> pos) & 1
                if sig == CONST0:
                    if b != 0:
                        ok = False
                        break
                elif sig == CONST1:
                    if b != 1:
                        ok = False
                        break
                else:
                    bits[sig] = b
            if self.is_dual:
                if idx < 32:
                    # lower half: O5 truth table over I0..I4
                    fn = self.fn_o5
                else:
                    fn = self.fn_o6
            else:
                fn = self.fn_o6
            if not ok:
                # unreachable row under tie constraints; re-evaluate anyway so
                # the table is fully specified (use raw bits, ties included)
                bits = {
                    sig: (idx >> pos) & 1
                    for pos, sig in enumerate(ins)
                    if sig not in (CONST0, CONST1)
                }
            if int(bool(fn(bits))):
                init |= 1 << idx
        return init

    # -- evaluation ---------------------------------------------------------
    def eval_direct(self, env: Dict[str, torch.Tensor]) -> None:
        env[self.out_o6] = self.fn_o6(env).to(torch.uint8) & 1
        if self.is_dual:
            env[self.out_o5] = self.fn_o5(env).to(torch.uint8) & 1

    def eval_init(self, env: Dict[str, torch.Tensor]) -> None:
        """Index the INIT word: the LUT's six pins form a 6-bit index into a
        64-entry bit table (a 64:1 mux, as the hardware's).  Tied pins add
        their constant to the index."""
        init = self.init_value()
        table = torch.tensor([(init >> k) & 1 for k in range(64)],
                             dtype=torch.uint8, device=_device(env))
        idx = 0
        for pos, sig in enumerate(self.padded_inputs):
            if sig == CONST1:
                idx = idx + (1 << pos)
            elif sig != CONST0:
                idx = idx + (env[sig].to(torch.int64) << pos)
        env[self.out_o6] = table[idx]
        if self.is_dual:
            # O5 reads the lower 32-bit half: I5 dropped from the index
            env[self.out_o5] = table[idx & 31]


@dataclasses.dataclass(frozen=True)
class Carry4:
    """The 7-series CARRY4 block: 4 (MUXCY + XORCY) stages.

    Per stage i:  O[i] = S[i] ^ C[i];  C[i+1] = S[i] ? C[i] : DI[i].
    ``cin`` may be a fabric signal (enters via CYINIT) or the name of another
    CARRY4's CO[3] (dedicated CO->CIN link -- ``cin_dedicated=True``), which
    matters only to the timing model.
    """

    name: str
    s: Sequence[str]                 # 4 signal names ("0"/"1" allowed)
    di: Sequence[str]                # 4 signal names
    cin: str
    o_out: Sequence[Optional[str]]   # names for O[0..3] (None = unused)
    co_out: Sequence[Optional[str]]  # names for CO[0..3] (None = unused)
    cin_dedicated: bool = False

    def evaluate(self, env: Dict[str, torch.Tensor]) -> None:
        # a tied pin is a 0-dim uint8 tensor on the signals' device, which
        # broadcasts against the live signals in `^` and `torch.where`
        dev = _device(env)
        const = {CONST0: torch.zeros((), dtype=torch.uint8, device=dev),
                 CONST1: torch.ones((), dtype=torch.uint8, device=dev)}

        def get(sig):
            return const[sig] if sig in const else env[sig]

        c = get(self.cin)
        for i in range(4):
            s_i = get(self.s[i])
            di_i = get(self.di[i])
            o_i = s_i ^ c
            c = torch.where(s_i == 1, c, di_i)
            if self.o_out[i] is not None:
                env[self.o_out[i]] = o_i
            if self.co_out[i] is not None:
                env[self.co_out[i]] = c


@dataclasses.dataclass
class Netlist:
    """An ordered netlist of LUTs and CARRY4s with named inputs/outputs."""

    name: str
    inputs: Sequence[str]
    outputs: Sequence[str]
    cells: Sequence[object]          # Lut | Carry4, in dependency order

    def evaluate_bits(
        self, env: Dict[str, torch.Tensor], mode: str = "direct"
    ) -> Dict[str, torch.Tensor]:
        env = dict(env)
        for cell in self.cells:
            if isinstance(cell, Lut):
                if mode == "init":
                    cell.eval_init(env)
                else:
                    cell.eval_direct(env)
            elif isinstance(cell, Carry4):
                cell.evaluate(env)
            else:
                raise TypeError(type(cell))
        return env

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 mode: str = "direct") -> torch.Tensor:
        """Multiply unsigned 4-bit tensors elementwise through the netlist.

        ``a``/``b`` are integer tensors with values in [0, 15] on one device;
        returns the uint8 product tensor of their broadcast shape on that
        device, computed bit-by-bit through the simulated gates.
        """
        a = torch.as_tensor(a)
        b = torch.as_tensor(b)
        env: Dict[str, torch.Tensor] = {}
        for i in range(4):
            env[f"A{i}"] = ((a >> i) & 1).to(torch.uint8)
            env[f"B{i}"] = ((b >> i) & 1).to(torch.uint8)
        env = self.evaluate_bits(env, mode=mode)
        out = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                          dtype=torch.uint8, device=a.device)
        for i, sig in enumerate(self.outputs):
            out = out | (env[sig].to(torch.uint8) << i)
        return out

    # -- resource accounting (paper Table II) -------------------------------
    def lut_count(self) -> int:
        return sum(1 for c in self.cells if isinstance(c, Lut))

    def carry4_count(self) -> int:
        return sum(1 for c in self.cells if isinstance(c, Carry4))

    def dual_lut_count(self) -> int:
        return sum(1 for c in self.cells if isinstance(c, Lut) and c.is_dual)

    def init_table(self) -> Dict[str, int]:
        return {c.name: c.init_value() for c in self.cells if isinstance(c, Lut)}
