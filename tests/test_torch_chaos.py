"""The chaos harness, port against the JAX package: the same seeded
fault-injection run (cancel and deadline storms, allocator failures,
injected step faults, snapshot/restore) through both engines gives the
same report, field for field.

The configs are 2 layers of the reduced qwen2-0.5b with W4A4-packed
weights in float32 (the integer GEMM is exact, so both packages emit the
same greedy tokens) and a pool small enough that the running set
preempts.  Each run's fault-free reference comes from the port's engine
and is handed to both harnesses, so every survivor of the JAX run is also
held to the port's tokens.  Seed 3 runs without a restore, seed 4 with a
snapshot/restore at step 4, both in the bucketed and the ragged step;
`CANCEL_STORM` runs bucketed.  In both modes seeds 3 and 4 preempt and
retry injected step faults; seed 3 also injects allocator failures and
seed 4 sheds.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.serving.chaos as jchaos  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.serving.chaos as tchaos  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402

F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")
#: 8 pages of 4 tokens for 2 slots of up to 28 tokens: the pool runs dry
SV = dict(layout="paged", max_batch=2, page_size=4, num_pages=8, max_ctx=32,
          max_queue=4)
#: the report fields that must agree (every field of run_chaos's report)
FIELDS = ("seed", "step_mode", "steps", "events", "outcomes", "survivors",
          "survivors_identical", "leaked_pages", "preemptions",
          "recompiles_steady_state", "pool_high_water")


@pytest.fixture(scope="module")
def setup():
    """Both packages' configs and the same W4A4 weights, built once."""
    jcfg = jconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    jrt = jconfigs.Runtime(**F32, remat="none", loss_chunk=0)
    jparams = j_build_params(jcfg, jrt, seed=0)
    tparams = prepack_tree(params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    tcfg = tconfigs.get_config("qwen2-0.5b").reduced(n_layers=2)
    return (jcfg, jrt, jparams), (tcfg, tconfigs.Runtime(**F32), tparams)


CASES = {
    "bucketed-seed3": ("bucketed", dict(seed=3)),
    "ragged-seed3": ("ragged", dict(seed=3)),
    "bucketed-seed4-restore": ("bucketed", dict(seed=4, stop_resume_at=(4,))),
    "ragged-seed4-restore": ("ragged", dict(seed=4, stop_resume_at=(4,))),
    "bucketed-cancel-storm": ("bucketed", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chaos_report_equals_jax_package(setup, case):
    (jcfg, jrt, jparams), (tcfg, trt, tparams) = setup
    step, knobs = CASES[case]
    if knobs is None:
        tch, jch = tchaos.CANCEL_STORM, jchaos.CANCEL_STORM
    else:
        tch, jch = (tchaos.ChaosConfig(**knobs),
                    jchaos.ChaosConfig(**knobs))
    assert dataclasses.asdict(tch) == dataclasses.asdict(jch)
    tsv = tconfigs.ServingConfig(**SV, step=step)
    trace = tchaos._make_trace(tch, tcfg.vocab)
    jtrace = jchaos._make_trace(jch, jcfg.vocab)
    assert all(a == b and np.array_equal(p, q) and m == n
               for (a, p, m), (b, q, n) in zip(trace, jtrace))
    ref = tchaos.reference_tokens(tcfg, trt, tsv, trace, params=tparams,
                                  device="cpu")
    got = tchaos.run_chaos(tcfg, trt, tsv, tch, params=tparams,
                           reference=ref, device="cpu")
    want = jchaos.run_chaos(jcfg, jrt, jconfigs.ServingConfig(**SV,
                                                              step=step),
                            jch, params=jparams, reference=ref)
    assert set(got) == set(want) == set(FIELDS)
    for field in FIELDS:
        assert got[field] == want[field], field
    assert got["leaked_pages"] == 0 and got["recompiles_steady_state"] == 0
    assert sum(got["outcomes"].values()) == tch.n_requests
    assert got["events"]["stop_resumes"] == len(tch.stop_resume_at)
    if knobs is None:
        assert got["events"]["cancels"] > 0
    else:
        assert got["preemptions"] > 0 and got["events"]["step_faults"] > 0
        hazard = "alloc_fails" if knobs["seed"] == 3 else "sheds"
        assert got["events"][hazard] > 0


def test_chaos_report_runs_both_modes(setup):
    """The port's `chaos_report` holds both step modes to one bucketed
    reference on the CPU (the plain versions run the same exact-softmax
    arithmetic in both) and aggregates their gates."""
    _, (tcfg, trt, tparams) = setup
    rep = tchaos.chaos_report(tcfg, trt, tconfigs.ServingConfig(**SV),
                              tchaos.ChaosConfig(seed=4,
                                                 stop_resume_at=(4,)),
                              params=tparams, device="cpu")
    assert [r["step_mode"] for r in rep["runs"]] == ["bucketed", "ragged"]
    assert rep["survivors_identical"] and rep["leaked_pages"] == 0
    assert rep["recompiles_steady_state"] == 0
