"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's ``repro.launch.roofline``: the analytic parameter and FLOP counts
of every config at every assigned shape equal exactly (``==``), and
``roofline_terms`` equals the JAX function's once the JAX module's four
hardware constants are set to the port's H100 ones (a module attribute
patched in the test; no JAX file changes).  The port's ``Shape``,
``SHAPES`` and ``runnable`` are the JAX package's field for field."""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402

ARCHS = sorted(tconfigs.REGISTRY)
SHAPES = sorted(tconfigs.SHAPES)


def test_shapes_and_runnable_equal_the_jax_package():
    assert sorted(jconfigs.SHAPES) == SHAPES
    for name in SHAPES:
        assert (dataclasses.asdict(tconfigs.SHAPES[name])
                == dataclasses.asdict(jconfigs.SHAPES[name]))
    for arch in ARCHS:
        tc, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert tc.sub_quadratic == jc.sub_quadratic, arch
        for name in SHAPES:
            assert (tconfigs.runnable(tc, tconfigs.SHAPES[name])
                    == jconfigs.runnable(jc, jconfigs.SHAPES[name])), \
                (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_and_flops_equal_the_jax_package(arch):
    tc, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert trl.model_params(tc) == jrl.model_params(jc)
    for name in SHAPES:
        got = trl.model_flops(tc, tconfigs.SHAPES[name])
        want = jrl.model_flops(jc, jconfigs.SHAPES[name])
        assert got == want and type(got) is type(want), (name, got, want)


TERMS = [(3.1e15, 2.2e12, 0.0), (1.0e12, 9.9e12, 4.0e9),
         (5.0e11, 1.0e9, 3.0e12), (0.0, 0.0, 0.0), (7.7e14, 6.1e11, 2.5e11)]


@pytest.mark.parametrize("int8_fraction", [0.0, 0.25, 1.0])
def test_roofline_terms_equal_the_jax_package(monkeypatch, int8_fraction):
    monkeypatch.setattr(jrl, "PEAK_FLOPS_BF16", trl.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jrl, "PEAK_FLOPS_INT8", trl.PEAK_FLOPS_INT8)
    monkeypatch.setattr(jrl, "HBM_BW", trl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW_PER_LINK", trl.NVLINK_BW)
    for f, b, c in TERMS:
        got = trl.roofline_terms(f, b, c, int8_fraction=int8_fraction)
        want = jrl.roofline_terms(f, b, c, int8_fraction=int8_fraction)
        assert got == want, (f, b, c)


def test_h100_constants():
    """The H100 SXM figures PERF.md's kernel bounds use, and NVLink 4's
    900 GB/s a GPU."""
    assert (trl.PEAK_FLOPS_BF16, trl.PEAK_FLOPS_INT8, trl.HBM_BW,
            trl.NVLINK_BW) == (989e12, 1979e12, 3.35e12, 900e9)
    assert not hasattr(trl, "parse_collectives")


def test_collective_stats_total():
    stats = trl.CollectiveStats({"all-reduce": 3.0, "all-gather": 4.5},
                                cross_pod_bytes=1.0, count=2)
    jstats = jrl.CollectiveStats({"all-reduce": 3.0, "all-gather": 4.5},
                                 cross_pod_bytes=1.0, count=2)
    assert stats.total() == jstats.total() == 7.5
