"""Port parity for the ``--layout compare`` harness
(``repro_torch.launch.serve``): on the CPU, ``serve(layout="compare")``
serves one trace through the five attention paths (paged, paged_gather,
contiguous, paged_nocache, ragged), reports ``bit_identical``, and every
path's tokens equal the JAX package's compare run's on the same weights.
Float weights in bf16 (``--quant-plan "*=float"``): bf16 W4A4 tokens are
not compared across the two packages (ROADMAP Queue 3 item 7).  The JAX
run (five engines) takes most of the file's time."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402

ARCH = "qwen2-0.5b"


COMPARE = dict(requests=4, prompt_lens=(8, 16), gen_lens=(4,), max_batch=2,
               num_pages=24, max_ctx=64, quant_plan="*=float")


def test_serve_compare_is_bit_identical_with_the_jax_paths(monkeypatch):
    """`serve(layout="compare")` on the CPU: five paths, bit-identical,
    and every path's tokens equal the JAX compare run's on the same
    weights (the JAX package's random masters)."""
    import repro.launch.serve as jserve
    import repro_torch.launch.serve as tserve

    tokens = {"jax": [], "port": []}

    def recorder(mod, key):
        real = mod.run_trace

        def run(engine, trace):
            stats, fin = real(engine, trace)
            tokens[key].append([list(r.tokens) for r in fin])
            return stats, fin
        return run

    monkeypatch.setattr(jserve, "run_trace", recorder(jserve, "jax"))
    monkeypatch.setattr(tserve, "run_trace", recorder(tserve, "port"))

    def port_params(cfg, rt, seed, device):
        jcfg = j_get_config(ARCH).reduced()
        masters = jax.tree.map(np.asarray, jt.init_model(
            jax.random.PRNGKey(seed), jcfg))
        return tplan.pack_for_serving(params_from_jax(masters, device), cfg,
                                      rt)

    monkeypatch.setattr(tserve, "build_params", port_params)
    jrep = jserve.serve(ARCH, layout="compare", **COMPARE)
    trep = tserve.serve(ARCH, layout="compare", device="cpu", **COMPARE)
    paths = ["paged", "paged_gather", "contiguous", "paged_nocache", "ragged"]
    assert jrep["bit_identical"] and trep["bit_identical"]
    assert all(trep[p]["requests_finished"] == 4 for p in paths)
    assert trep["recompiles_steady_state"] == 0
    assert len(tokens["port"]) == len(tokens["jax"]) == len(paths)
    assert tokens["port"] == tokens["jax"]
    for p in paths:
        for key in ("prefill_tokens", "decode_tokens", "steps"):
            assert trep[p][key] == jrep[p][key], (p, key)
