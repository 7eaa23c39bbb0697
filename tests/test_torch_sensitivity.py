"""Port parity for the per-site sensitivity sweep: reduced qwen2-0.5b (2
layers) through ``repro_torch.launch.sensitivity.sensitivity_sweep`` against
``repro.launch.sensitivity.sensitivity_sweep`` on the same weights and
tokens (the JAX function's own draws from the seed, handed to the port
through ``params_from_jax``), both in float32.

Float32 is set by replacing each module's ``Runtime`` in the test (neither
package has a dtype knob on the sweep).  Both run the same integer GEMMs
on the same quantized values and differ in float32 summation order
outside them, so every MSE agrees within 1e-3 relative and the rows come
in the same order; the port's int_sim and lut4 rows are equal (the same
integers), as the JAX package's are.
"""

import dataclasses
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import sensitivity as jsens  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import sensitivity as tsens  # noqa: E402

SEED, BATCH, SEQ = 0, 2, 16
RTOL = 1e-3


def _float32(module):
    base = module.Runtime

    def make(**kw):
        return dataclasses.replace(base(**kw), compute_dtype="float32")
    return make


@pytest.fixture(scope="module")
def sweeps():
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsens, "Runtime", _float32(jsens))
        mp.setattr(tsens, "Runtime", _float32(tsens))
        jcfg = j_get_config("qwen2-0.5b").reduced(n_layers=2)
        cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
        want = jsens.sensitivity_sweep(jcfg, batch=BATCH, seq=SEQ, seed=SEED)
        # the JAX function's draws from the seed
        key = jax.random.PRNGKey(SEED)
        jp = jt.init_model(key, jcfg)
        tokens = jax.random.randint(jax.random.fold_in(key, 1), (BATCH, SEQ),
                                    0, jcfg.vocab, dtype=jnp.int32)
        got = tsens.sensitivity_sweep(
            cfg, seed=SEED, device="cpu",
            params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            tokens=torch.from_numpy(np.array(tokens)))
    finally:
        mp.undo()
    return want, got


def test_same_report_keys_and_header(sweeps):
    want, got = sweeps
    assert sorted(got) == sorted(want)
    for key in ("arch", "base_backend", "batch", "seq"):
        assert got[key] == want[key]
    assert tsens.COMPARE_BACKENDS == jsens.COMPARE_BACKENDS
    cfg = get_config("qwen2-0.5b")
    assert list(tsens.default_groups(cfg)) == list(
        jsens.default_groups(j_get_config("qwen2-0.5b")))


def test_same_sites_in_the_same_order(sweeps):
    want, got = sweeps
    assert [r["site"] for r in got["per_site"]] \
        == [r["site"] for r in want["per_site"]]
    assert [(r["backend"], r["plan"]) for r in got["backends"]] \
        == [(r["backend"], r["plan"]) for r in want["backends"]]


def test_every_mse_within_relative_tolerance(sweeps):
    want, got = sweeps
    pairs = [(got["uniform_mse_vs_float"], want["uniform_mse_vs_float"])]
    pairs += [(g["mse_vs_float"], w["mse_vs_float"])
              for g, w in zip(got["per_site"], want["per_site"])]
    pairs += [(g["mse_vs_float"], w["mse_vs_float"])
              for g, w in zip(got["backends"], want["backends"])]
    for g, w in pairs:
        assert np.isfinite(g) and g > 0
        np.testing.assert_allclose(g, w, rtol=RTOL)
    for g, w in zip(got["per_site"], want["per_site"]):
        # deltas are differences of the MSEs: held to the MSE scale
        np.testing.assert_allclose(g["delta_vs_uniform"],
                                   w["delta_vs_uniform"],
                                   atol=RTOL * want["uniform_mse_vs_float"])


def test_int_sim_and_lut4_rows_equal(sweeps):
    want, got = sweeps
    for report in (got, want):
        rows = {r["backend"]: r["mse_vs_float"] for r in report["backends"]}
        assert rows["int_sim"] == rows["lut4"]


def test_cli_sweep_adds_the_jax_reports_section(sweeps, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --sweep`` puts the sweep under
    ``report["sensitivity"]`` with the JAX report's keys."""
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2-0.5b", "--reduced", "--layers", "1",
        "--device", "cpu", "--requests", "2", "--prompt-lens", "8",
        "--gen-lens", "2", "--max-batch", "2", "--num-pages", "8",
        "--max-ctx", "32", "--sweep"])
    tserve.main()
    report = json.loads(capsys.readouterr().out)
    want, _ = sweeps
    sens = report["sensitivity"]
    assert sorted(sens) == sorted(want)
    assert sorted(sens["per_site"][0]) == sorted(want["per_site"][0])
    assert sorted(sens["backends"][0]) == sorted(want["backends"][0])
