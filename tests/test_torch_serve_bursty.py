"""The serve CLI's ``--burst`` and ``--period`` flags
(``repro_torch.launch.serve``, the JAX CLI's defaults 4 and 8): a bursty
run through each package's command line on the CPU, with ``--burst 2
--period 3``, serves the JAX CLI's trace (arrival steps, prompts, lengths)
and emits its greedy tokens, on the JAX package's random masters.  Float
weights in bf16 (``--quant-plan "*=float"``): bf16 W4A4 tokens are not
compared across the two packages (ROADMAP Queue 3 item 7)."""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402

ARCH = "qwen2-0.5b"
ARGS = ["--arch", ARCH, "--layers", "2", "--scenario", "bursty",
        "--burst", "2", "--period", "3", "--requests", "5",
        "--prompt-lens", "8,16", "--gen-lens", "3,5", "--max-batch", "2",
        "--num-pages", "24", "--max-ctx", "64", "--quant-plan", "*=float"]


def test_bursty_cli_serves_the_jax_trace_and_tokens(monkeypatch, capsys):
    import repro.launch.serve as jserve
    import repro_torch.launch.serve as tserve

    seen = {"jax": [], "port": []}

    def recorder(mod, key):
        real = mod.run_trace

        def run(engine, trace):
            stats, fin = real(engine, trace)
            seen[key].append(([(t.arrival_step, list(map(int, t.prompt)),
                                t.max_new) for t in trace],
                              [list(r.tokens) for r in fin]))
            return stats, fin
        return run

    monkeypatch.setattr(jserve, "run_trace", recorder(jserve, "jax"))
    monkeypatch.setattr(tserve, "run_trace", recorder(tserve, "port"))

    def port_params(cfg, rt, seed, device):
        jcfg = j_get_config(ARCH).reduced(n_layers=2)
        masters = jax.tree.map(np.asarray, jt.init_model(
            jax.random.PRNGKey(seed), jcfg))
        return tplan.pack_for_serving(params_from_jax(masters, device), cfg,
                                      rt)

    monkeypatch.setattr(tserve, "build_params", port_params)
    monkeypatch.setattr(sys, "argv", ["serve", *ARGS])
    jserve.main()
    jrep = json.loads(capsys.readouterr().out)
    tserve.main([*ARGS, "--device", "cpu"])
    trep = json.loads(capsys.readouterr().out)

    (jtrace, jtok), = seen["jax"]
    (ttrace, ttok), = seen["port"]
    # 5 requests in bursts of 2 every 3 steps: arrivals at steps 0, 0, 3,
    # 3, 6
    assert [a for a, _, _ in ttrace] == [0, 0, 3, 3, 6]
    assert ttrace == jtrace
    assert ttok == jtok
    assert trep["scenario"] == jrep["scenario"] == "bursty"
    for key in ("prefill_tokens", "decode_tokens", "steps",
                "requests_finished"):
        assert trep["paged"][key] == jrep["paged"][key], key
