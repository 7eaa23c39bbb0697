"""Port parity for the paper's circuit: the LUT6/CARRY4 netlist, the proposed
multiplier and the two re-implemented baselines, their INIT tables, area,
timing and pipelining models, against the JAX package on the same inputs.

Everything here is integer or pure Python, so every comparison is exact:
INIT words, all 256 products in both evaluation modes, seeded numpy tensors
(broadcast shapes included), resource counts, the timing model's numbers,
the pipelined report and the published rows.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import pipeline_mult as jpipe  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core import timing as jtiming  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import pipeline_mult as tpipe  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core import timing as ttiming  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DESIGNS = ("proposed", "lm", "acc_ullah")
BUILDERS = {
    "proposed": "build_proposed_mult4",
    "lm": "build_lm_mult4",
    "acc_ullah": "build_acc_mult4",
}
MODES = ("direct", "init")
RNG = np.random.default_rng(20261017)

A_ALL = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 16, axis=1)
B_ALL = A_ALL.T.copy()
EXACT = (A_ALL.astype(np.uint32) * B_ALL).astype(np.uint8)


def _pair(design):
    name = BUILDERS[design]
    return getattr(jcore, name)(), getattr(tcore, name)()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("design", DESIGNS)
def test_init_tables_equal(design):
    jnl, tnl = _pair(design)
    assert tnl.init_table() == jnl.init_table()
    assert [c.name for c in tnl.cells] == [c.name for c in jnl.cells]


def test_paper_lut1_init_matches_printed_value():
    assert tcore.build_proposed_mult4().init_table()["LUT1"] \
        == 0x78887888A0A0A0A0


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("mode", MODES)
def test_all_256_pairs_equal(design, mode):
    jnl, tnl = _pair(design)
    got = tnl(_t(A_ALL), _t(B_ALL), mode=mode)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (16, 16)
    np.testing.assert_array_equal(got.numpy(), EXACT)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnl(jnp.asarray(A_ALL), jnp.asarray(B_ALL),
                                    mode=mode)))


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape_a,shape_b", [((3, 7, 5), (3, 7, 5)),
                                             ((4, 1, 6), (1, 9, 6)),
                                             ((11,), (2, 11))])
def test_seeded_tensors_equal(design, mode, shape_a, shape_b):
    """Seeded int operands of several dtypes and broadcast shapes: the
    port's products equal the JAX package's and a * b; the result has the
    broadcast shape."""
    jnl, tnl = _pair(design)
    a = RNG.integers(0, 16, size=shape_a, dtype=np.uint8)
    b = RNG.integers(0, 16, size=shape_b, dtype=np.uint8)
    want = np.asarray(jnl(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = tnl(_t(a).to(torch.int32), _t(b), mode=mode)
    assert tuple(got.shape) == np.broadcast_shapes(shape_a, shape_b)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), (a.astype(np.int32) * b)
                                  .astype(np.uint8))


@pytest.mark.parametrize("design", DESIGNS)
def test_counts_resources_and_timing_equal(design):
    jnl, tnl = _pair(design)
    for fn in ("lut_count", "carry4_count", "dual_lut_count"):
        assert getattr(tnl, fn)() == getattr(jnl, fn)()
    assert tcore.resources(tnl) == jcore.resources(jnl)
    assert tcore.analyze(tnl) == jcore.analyze(jnl)
    slow = dict(T_NET=0.5, T_LUT=0.2)
    assert tcore.analyze(tnl, tcore.DelayModel(**slow)) \
        == jcore.analyze(jnl, jcore.DelayModel(**slow))


def test_proposed_reads_the_papers_numbers():
    """Table II/III of the paper for the proposed design: 11 LUTs (three
    dual-output), 2 CARRY4, CPD 2.750 ns = 1.302 logic + 1.448 net."""
    nl = tcore.build_proposed_mult4()
    assert tcore.resources(nl)["luts"] == 11
    assert tcore.resources(nl)["carry4"] == 2
    assert [c.name for c in nl.cells
            if isinstance(c, tcore.Lut) and c.is_dual] == ["LUT1", "LUT5",
                                                           "LUT7"]
    t = tcore.analyze(nl)
    assert (t["cpd"], t["logic"], t["net"]) == (2.75, 1.302, 1.448)


def test_pipelined_report_and_stage_cpds_equal():
    assert tpipe.pipelined_report() == jpipe.pipelined_report()
    assert tpipe.STAGE1_REGS == jpipe.STAGE1_REGS
    regs = ("P0", "P1", "P2", "C0")
    assert ttiming.pipeline_stage_cpds(tcore.build_lm_mult4(), regs) \
        == jtiming.pipeline_stage_cpds(jcore.build_lm_mult4(), regs)
    got = tpipe.pipelined_mult4(_t(A_ALL), _t(B_ALL))
    np.testing.assert_array_equal(got.numpy(), EXACT)


def test_published_rows_equal():
    assert tcore.PUBLISHED_ROWS == jcore.PUBLISHED_ROWS


def test_behavioral_mult4_equal():
    got = tcore.behavioral_mult4(_t(A_ALL), _t(B_ALL))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcore.behavioral_mult4(jnp.asarray(A_ALL),
                                                       jnp.asarray(B_ALL))))


def test_to_unsigned_mag_equal():
    q = np.arange(-8, 8, dtype=np.int8).repeat(3).reshape(6, 8)
    jm, js = jq.to_unsigned_mag(jnp.asarray(q))
    tm, ts = tq.to_unsigned_mag(_t(q))
    assert tm.dtype == torch.uint8 and ts.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", MODES)
def test_mul4_plain_version_equals_the_netlist(mode):
    """As tests/test_kernels.py holds the JAX kernel: the elementwise table
    product (its plain version here) equals the circuit on signed int4
    operands split into magnitude and sign."""
    a = RNG.integers(-8, 8, size=(4, 300), dtype=np.int8)
    b = RNG.integers(-8, 8, size=(4, 300), dtype=np.int8)
    ma, sa = tq.to_unsigned_mag(_t(a))
    mb, sb = tq.to_unsigned_mag(_t(b))
    via_netlist = (tcore.build_proposed_mult4()(ma, mb, mode=mode)
                   .to(torch.int32) * sa * sb)
    got = ops.mul4(_t(a), _t(b))
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  via_netlist.numpy())


def test_output_device_follows_the_input():
    """CPU operands compute on the CPU, in both modes, including a CARRY4's
    tied pins (chain B ties all of S and DI)."""
    nl = tcore.build_proposed_mult4()
    a = torch.tensor([15, 7], dtype=torch.uint8)
    for mode in MODES:
        out = nl(a, a, mode=mode)
        assert out.device == a.device
        assert out.tolist() == [225, 49]
    meta = torch.empty((3,), dtype=torch.uint8, device="meta")
    out = nl(meta, meta)
    assert out.device.type == "meta" and tuple(out.shape) == (3,)


def test_quickstart_runs_on_the_cpu(capsys):
    """examples/quickstart_torch.py's four steps with the plain versions."""
    import runpy
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "examples" \
        / "quickstart_torch.py"
    runpy.run_path(str(script))["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "0x78887888A0A0A0A0" in out and out.endswith("quickstart OK\n")
