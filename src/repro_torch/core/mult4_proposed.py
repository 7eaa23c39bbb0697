"""The proposed 11-LUT / 2-CARRY4 exact 4-bit multiplier (paper Fig. 4 + Table I);
a copy of ``repro/core/mult4_proposed.py`` over the port's netlist.

Signal naming follows the paper: A0..A3 multiplicand bits, B0..B3 multiplier
bits, P0..P7 product bits.  Intermediate signals (S1, S3, C0, Prop*/Gen*) match
Table I.  The Boolean functions of Table I column 2 are normative; INIT words
are synthesized from them rather than transcribed from the printed strings
(LUT1's synthesized word equals the printed one, which the tests check).

Arithmetic structure (derivation from the paper's Fig. 3/4 discussion):

  col0: P0 = A0B0
  col1: P1 = A1B0 ^ A0B1, carry c1 = A1B0·A0B1
  col2: {A2B0, A1B1, A0B2, c1}:  P2 = xor4,  C0 = "at least two" (the c1 term
        appears alone because c1=1 forces A1B1=1 -- the paper's logical
        dominance), and the quadruple-ones case is absorbed by adding
        T = A2B0·A1B1·A0B2 at column 3 (T=1 forces c1=1, v=4, and the
        weight-16 deficit is exactly C0(8) + T(8)).
  col3: trio (A1B2, A2B1, T) pre-summed into S1 with carry C1 = A1B2·A2B1
        (dominance: T=1 forces A1B2=A2B1=1); then the CARRY4 adds
        (S1 ^ A3B0) half-adder pair, A0B3 and C0:
            P3 = Prop0 ^ C0,   Prop0 = (S1^A3B0)^A0B3, Gen0 = (S1^A3B0)·A0B3
        with g = S1·A3B0 deferred to column 4 (added inside Prop1).
  col4: S2 = A3B1^A2B2^A1B3, S3 = S2 ^ C1 (carry C3 = S2·C1 deferred),
            P4 = Prop1 ^ CO0,  Prop1 = S3 ^ g,  Gen1 = S3·g,  g = S1·A3·B0
  col5: C2 = maj3(A3B1,A2B2,A1B3), S4 = A3B2^A2B3^C2,
            P5 = Prop2 ^ CO1,  Prop2 = S4 ^ C3,  Gen2 = S4·C3
  col6: C4 = maj3(A3B2,A2B3,C2),
            P6 = Prop3 ^ CO2,  Prop3 = A3B3 ^ C4, Gen3 = A3B3·C4
  col7: P7 = CO3, exported through a second CARRY4 (chain B) whose XORCY with
        S='0' turns the dedicated-carry CO into a fabric output -- the paper's
        two-CARRY4 trick that avoids the slow CO3->fabric->LUT path.

Exhaustive 256-pair exactness is asserted in tests (paper §V).
"""

from __future__ import annotations

from .netlist import CONST0, CONST1, Carry4, Lut, Netlist


def _and(*xs):
    out = None
    for x in xs:
        out = x if out is None else out & x
    return out


def build_proposed_mult4() -> Netlist:
    e = lambda env, n: env[n]  # noqa: E731

    lut1 = Lut(
        name="LUT1",
        inputs=["A0", "B1", "B0", "A1", CONST1, CONST1],
        fn_o6=lambda v: (v["A1"] & v["B0"]) ^ (v["A0"] & v["B1"]),
        out_o6="P1",
        fn_o5=lambda v: v["A0"] & v["B0"],
        out_o5="P0",
    )
    lut2 = Lut(
        name="LUT2",
        inputs=["A2", "B0", "A0", "B1", "A1", "B2"],
        fn_o6=lambda v: (v["A2"] & v["B0"])
        ^ (v["A1"] & v["B1"])
        ^ (v["A0"] & v["B2"])
        ^ ((v["A0"] & v["B1"]) & (v["A1"] & v["B0"])),
        out_o6="P2",
    )
    lut3 = Lut(
        name="LUT3",
        inputs=["B2", "A2", "B0", "A0", "B1", "A1"],
        fn_o6=lambda v: ((v["A1"] & v["B1"]) & (v["A0"] & v["B2"]))
        | ((v["A2"] & v["B0"]) & (v["A1"] & v["B1"]))
        | ((v["A2"] & v["B0"]) & (v["A0"] & v["B2"]))
        | ((v["A0"] & v["B1"]) & (v["A1"] & v["B0"])),
        out_o6="C0",
    )
    lut4 = Lut(
        name="LUT4",
        inputs=["A1", "B2", "A2", "A0", "B1", "B0"],
        fn_o6=lambda v: (v["A1"] & v["B2"])
        ^ (v["A2"] & v["B1"])
        ^ _and(v["A1"] & v["B1"], v["A0"] & v["B2"], v["A2"] & v["B0"]),
        out_o6="S1",
    )
    lut5 = Lut(
        name="LUT5",
        inputs=["B3", "A0", "S1", "A3", "B0", CONST1],
        fn_o6=lambda v: (v["S1"] ^ (v["A3"] & v["B0"])) ^ (v["A0"] & v["B3"]),
        out_o6="Prop0",
        fn_o5=lambda v: (v["S1"] ^ (v["A3"] & v["B0"])) & (v["A0"] & v["B3"]),
        out_o5="Gen0",
    )

    def _s2(v):
        return (v["A3"] & v["B1"]) ^ (v["A2"] & v["B2"]) ^ (v["A1"] & v["B3"])

    def _c1(v):
        return (v["A1"] & v["B2"]) & (v["A2"] & v["B1"])

    lut6 = Lut(
        name="LUT6",
        inputs=["B3", "A1", "B1", "A3", "B2", "A2"],
        fn_o6=lambda v: _s2(v) ^ _c1(v),
        out_o6="S3",
    )
    lut7 = Lut(
        name="LUT7",
        inputs=["B0", "S1", "A3", "S3", CONST1, CONST1],
        fn_o6=lambda v: v["S3"] ^ _and(v["S1"], v["A3"], v["B0"]),
        out_o6="Prop1",
        fn_o5=lambda v: v["S3"] & _and(v["S1"], v["A3"], v["B0"]),
        out_o5="Gen1",
    )

    def _c2(v):
        x, y, z = v["A3"] & v["B1"], v["A2"] & v["B2"], v["A1"] & v["B3"]
        return (x & y) | (y & z) | (x & z)

    def _s4(v):
        return (v["A3"] & v["B2"]) ^ (v["A2"] & v["B3"]) ^ _c2(v)

    def _c3(v):
        return _s2(v) & _c1(v)

    lut8 = Lut(
        name="LUT8",
        inputs=["A2", "B1", "B3", "A1", "B2", "A3"],
        fn_o6=lambda v: _s4(v) ^ _c3(v),
        out_o6="Prop2",
    )
    lut9 = Lut(
        name="LUT9",
        inputs=["A2", "B1", "B3", "A1", "B2", "A3"],
        fn_o6=lambda v: _s4(v) & _c3(v),
        out_o6="Gen2",
    )

    def _c4(v):
        x, y, z = v["A3"] & v["B2"], v["A2"] & v["B3"], _c2(v)
        return (x & y) | (y & z) | (x & z)

    lut10 = Lut(
        name="LUT10",
        inputs=["B2", "B1", "A3", "A1", "A2", "B3"],
        fn_o6=lambda v: (v["A3"] & v["B3"]) ^ _c4(v),
        out_o6="Prop3",
    )
    lut11 = Lut(
        name="LUT11",
        inputs=["A2", "B1", "B2", "A1", "B3", "A3"],
        fn_o6=lambda v: (v["A3"] & v["B3"]) & _c4(v),
        out_o6="Gen3",
    )

    chain_a = Carry4(
        name="CarryChainA",
        s=["Prop0", "Prop1", "Prop2", "Prop3"],
        di=["Gen0", "Gen1", "Gen2", "Gen3"],
        cin="C0",
        o_out=["P3", "P4", "P5", "P6"],
        co_out=[None, None, None, "CO3A"],
    )
    # Chain B: converts CO3A (dedicated CO->CIN link) into fabric output P7
    # via XORCY with S=0.  This is the paper's reason for the second CARRY4.
    chain_b = Carry4(
        name="CarryChainB",
        s=[CONST0, CONST0, CONST0, CONST0],
        di=[CONST0, CONST0, CONST0, CONST0],
        cin="CO3A",
        o_out=["P7", None, None, None],
        co_out=[None, None, None, None],
        cin_dedicated=True,
    )

    return Netlist(
        name="proposed",
        inputs=[f"A{i}" for i in range(4)] + [f"B{i}" for i in range(4)],
        outputs=[f"P{i}" for i in range(8)],
        cells=[lut1, lut2, lut3, lut4, lut5, lut6, lut7, lut8, lut9, lut10, lut11,
               chain_a, chain_b],
    )
