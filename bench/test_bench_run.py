"""A whole run, on the CPU at a tiny size through the port's plain kernel
versions: the harness's look for a card skipped, everything else as on the
card.  A sound run comes out correct; a run whose served tokens are
altered where they are produced comes out not correct (the attention's
faults: `test_bench_faults.py`); the controls (the reference in fp8 in the
program's place, and the program's own int8 KV pool) fail limits the sound
run holds."""

import dataclasses
import time

import pytest
import torch

import control
from harness import cell, manifest

MAN = manifest.load()
LIMITS = {"kv0_rel_err": 0.003, "attn_decode_err": 0.1,
          "attn_prefill_err": 0.1, "attn_prefill_row_err": 0.25,
          "ffn_err": 0.12, "kv_write_err": 0.003,
          "head_err": 0.02, "replay_mismatch": 0, "p90_rank_share": 0.2,
          "out_of_vocab": 0, "min_tokens_checked": 10}
#: the layer numbers the fp8 control has to fail
LAYER_NUMBERS = ("kv0_rel_err", "attn_decode_err", "attn_prefill_err",
                 "ffn_err", "kv_write_err", "head_err")
CLOSED = {"loop": "closed", "requests": 256, "admit_in_setup": True,
          "prompt_tokens": {"min": 8, "max": 32},
          "output_tokens": {"min": 8, "max": 24}, "stratum": 4,
          "check_requests": 2}
OPEN = {"loop": "open", "rate_per_s": 6.0, "arrivals_seed": 0,
        "prompt_tokens": {"min": 16, "max": 64},
        "output_tokens": {"min": 4, "max": 12}, "check_requests": 3}


@pytest.fixture
def tiny(monkeypatch):
    """A configuration file for the port's reduced config of `arch`."""
    from repro_torch.configs import REGISTRY, get_config

    def make(arch):
        name = "tiny-" + arch
        c = dataclasses.replace(get_config(arch).reduced(), name=name)
        monkeypatch.setitem(REGISTRY, name, c)
        model = {"hidden_size": c.d_model, "intermediate_size": c.d_ff,
                 "num_attention_heads": c.n_heads,
                 "num_key_value_heads": c.n_kv_heads, "head_dim": c.hd,
                 "num_hidden_layers": 2, "vocab_size": c.vocab_padded,
                 "hidden_act": ("silu" if c.ffn_type == "swiglu"
                                else "gelu_pytorch_tanh"),
                 "qkv_bias": c.qkv_bias, "mlp_bias": c.mlp_bias,
                 "rope_theta": c.rope_theta, "rms_norm_eps": c.norm_eps}
        serving = {"quant_plan": "serve_w4a4", "compute_dtype": "bfloat16",
                   "cache_dtype": "bfloat16", "attn_impl": "flash",
                   "layout": "paged", "step": "bucketed", "max_batch": 4,
                   "page_size": 16, "max_ctx": 128, "num_pages": 64,
                   "prefix_cache": True}
        return {"name": name, "arch": name, "model": model,
                "serving": serving}
    return make


def execute(cfg, mix, fault=None, controls=(), traced=False, seed=11,
            seconds=1.5):
    names = (MAN["per_layer"] if traced else MAN["end_to_end"])
    return cell.execute({"name": "tiny"}, cfg, mix, LIMITS, names, seed,
                        seconds, traced, "cpu", time.perf_counter(),
                        fault=fault, controls=controls,
                        out=lambda line: None)


@pytest.mark.parametrize("arch,mix", [("internlm2-20b", CLOSED),
                                      ("starcoder2-7b", OPEN)])
def test_sound_run_is_correct_and_the_control_is_not(tiny, arch, mix):
    res = execute(tiny(arch), mix, controls=(torch.float8_e4m3fn,))
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in MAN["end_to_end"]}
    assert res["metrics"]["setup_s"]["value"] > 0
    ctl = res["controls"][str(torch.float8_e4m3fn)]
    for name in LAYER_NUMBERS:
        assert res["readings"][name] <= LIMITS[name], name
        assert ctl[name] > LIMITS[name], name
    assert ctl["kv0_rel_err"] > 3 * LIMITS["kv0_rel_err"]
    # every layer of a prefill and a decode step was read, and the
    # captured step and the eager one gave the same tokens
    assert res["readings"]["replay_mismatch"] == 0


@pytest.mark.parametrize("arch,mix", [("internlm2-20b", CLOSED),
                                      ("starcoder2-7b", OPEN)])
def test_the_int8_pool_is_not_correct(tiny, arch, mix):
    cfg = tiny(arch)
    cfg["serving"]["cache_dtype"] = "int8"
    res = execute(cfg, mix)
    assert not res["correct"]
    assert res["check"]["kv0_rel_err"]["value"] > LIMITS["kv0_rel_err"]


@pytest.mark.parametrize("arch,mix", [("internlm2-20b", CLOSED),
                                      ("starcoder2-7b", OPEN)])
def test_altered_tokens_are_not_correct(tiny, arch, mix):
    res = execute(tiny(arch), mix, fault=control.alter_tokens)
    assert not res["correct"]
    assert res["check"]["p90_rank_share"]["value"] > \
        3 * LIMITS["p90_rank_share"]
    # the captured step's tokens are not the eager step's
    assert res["check"]["replay_mismatch"]["value"] > 0


def test_traced_run_reads_its_per_layer_metrics(tiny):
    # a closed batch: most steps decode only, however slow the host
    res = execute(tiny("internlm2-20b"), CLOSED, traced=True, seconds=3.0)
    got = set(res["metrics"])
    assert {"step.decode_ms", "mfu.decode"} <= got
    assert got <= {m["name"] for m in MAN["per_layer"]}
    # the CPU trace holds no device operation: no roofline is read
    assert not any(n.endswith("_roofline") for n in got)
    assert "breakdown" in res and "busy_s" in res["device"]
