"""Port parity for quantization plans and the serving path under them:
every preset, inline spec and JSON plan resolves every qwen2-0.5b site as
the JAX package resolves it; plan packing gives the JAX package's bytes and
scales, also for a plan that differs between layers; and on a reduced
config in float32 the port's engine emits the JAX engine's greedy tokens
under W4A16 (pre-packed and on the fly), the mixed plan and the
table-lookup plan.  The JAX engines run once per file, in a module-scoped
fixture."""

import dataclasses
import inspect
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.core.quant_plan as jplan  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.core.quant_plan as tplan  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "qwen2-0.5b"

INLINE_SPECS = [
    "block[0].*=float;ffn.*=w4a16/g128;*=int_sim",
    "*=w4a16_packed/g128;lm_head=float",
    "*=lut4/w4/a4;lm_head=float",
    "*=w4a16/g64/w4/a16; attn.wo=fake_quant ;block[23].*=float;lm_head=float",
    "*=int_sim;block[1?].ffn.w_out=w4a16;lm_head=w4a4_packed",
]


def _sites(cfg):
    sites = ["lm_head", ""]
    for i in range(cfg.n_layers):
        sites += [f"block[{i}].{leaf}"
                  for leaf in tplan.block_leaf_sites("A", cfg)]
    return sites


def _resolutions(plan, cfg):
    return {s: dataclasses.asdict(plan.resolve(s)) for s in _sites(cfg)}


def _assert_same_plan(jp, tp):
    cfg = tconfigs.get_config(ARCH)
    assert tp.name == jp.name
    assert _resolutions(tp, cfg) == _resolutions(jp, cfg)
    assert tplan.plan_repeat_uniform(tp, cfg) == jplan.plan_repeat_uniform(
        jp, jconfigs.get_config(ARCH))


@pytest.mark.parametrize("name", sorted(jplan.PRESETS))
def test_presets_resolve_every_site_as_the_jax_package(name):
    assert sorted(tplan.PRESETS) == sorted(jplan.PRESETS)
    _assert_same_plan(jplan.get_plan(name), tplan.get_plan(name))


@pytest.mark.parametrize("spec", INLINE_SPECS)
def test_inline_specs_resolve_every_site_as_the_jax_package(spec):
    _assert_same_plan(jplan.get_plan(spec), tplan.get_plan(spec))


@pytest.mark.parametrize("spec", ["ffn.*", "*=int_sim/x3", "*=;lm_head=float",
                                  "no_such_preset"])
def test_bad_specs_raise_as_in_the_jax_package(spec):
    with pytest.raises(ValueError) as jerr:
        jplan.get_plan(spec)
    with pytest.raises(ValueError) as terr:
        tplan.get_plan(spec)
    assert str(terr.value) == str(jerr.value)


def test_a_site_no_rule_matches_raises():
    plan = tplan.get_plan("ffn.*=w4a16")
    assert plan.resolve("block[2].ffn.w_in").backend == "w4a16"
    with pytest.raises(ValueError, match="matches no rule"):
        plan.resolve("block[2].attn.qkv")


def test_json_plans_and_their_mtime_cache(tmp_path):
    path = tmp_path / "plan.json"
    first = jplan.PRESETS["mixed_sensitive"]
    path.write_text(json.dumps(jplan.plan_to_dict(first)))
    _assert_same_plan(jplan.get_plan(str(path)), tplan.get_plan(str(path)))
    second = jplan.get_plan("*=w4a16/g32;lm_head=float")
    path.write_text(json.dumps(jplan.plan_to_dict(second)))
    st = path.stat()
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    _assert_same_plan(jplan.get_plan(str(path)), tplan.get_plan(str(path)))
    assert tplan.get_plan(str(path)).resolve("ffn.w_in").group_size == 32


def test_active_plan_precedence():
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH),
                               quant_plan="uniform_w4a4")
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH),
                               quant_plan="uniform_w4a4")
    for kw in ({}, {"quant_backend": "lut4"},
               {"quant_plan": "mixed_sensitive"},
               {"quant_plan": "*=w4a16/g64", "quant_backend": "int_sim"}):
        jp = jplan.active_plan(jcfg, jconfigs.Runtime(**kw))
        tp = tplan.active_plan(tcfg, tconfigs.Runtime(**kw))
        _assert_same_plan(jp, tp)
        assert tconfigs.Runtime(**kw).quant_cfg(tcfg, "block[3].ffn.w_in") \
            == tp.resolve("block[3].ffn.w_in")
    _assert_same_plan(
        jplan.active_plan(jconfigs.get_config(ARCH), jconfigs.Runtime()),
        tplan.active_plan(tconfigs.get_config(ARCH), tconfigs.Runtime()))


# ------------------------------------------------------------- packing ----
PACK_PLANS = ["*=w4a16_packed/g128",
              "*=w4a16_packed/g32;block[1].ffn.*=w4a4_packed;"
              "block[0].attn.*=float;lm_head=float"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for r, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/r{r}/u0")
    else:
        yield prefix, tree


@pytest.mark.parametrize("spec", PACK_PLANS)
def test_plan_pack_tree_same_bytes_and_scales(spec):
    """d_model 256 and d_ff 512 so G = 128 makes real groups; the second
    plan differs between layers and splits the layer stack (the JAX
    package's per-repeat subtrees, the port's per-layer list)."""
    over = dict(n_layers=2, d_model=256, d_ff=512)
    jcfg = jconfigs.get_config(ARCH).reduced(**over)
    cfg = tconfigs.get_config(ARCH).reduced(**over)
    masters = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(4),
                                                    jcfg))
    jp, tp = jplan.get_plan(spec), tplan.get_plan(spec)
    j_log, t_log = {}, {}
    j_packed = jplan.plan_pack_tree(jax.tree.map(jax.numpy.asarray, masters),
                                    jcfg, jp, site_log=j_log)
    t_packed = tplan.plan_pack_tree(params_from_jax(masters, "cpu"), cfg, tp,
                                    site_log=t_log)
    assert t_log == j_log and t_log
    uniform = tplan.plan_repeat_uniform(tp, cfg)
    assert isinstance(t_packed["layers"], dict) == uniform
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_packed)))
    t_leaves = dict(_leaves(t_packed))
    assert sorted(t_leaves) == sorted(j_leaves)
    assert any(leaf.ndim == (4 if uniform else 3)
               for k, leaf in t_leaves.items() if k.endswith("/scale"))
    for name, leaf in j_leaves.items():
        got = t_leaves[name].numpy()
        assert got.dtype == leaf.dtype, name
        np.testing.assert_array_equal(got, leaf, err_msg=name)


# ----------------------------------------------------------- the engine ----
ENGINE_SV = dict(layout="paged", max_batch=3, page_size=4, num_pages=16,
                 max_ctx=40, prefix_cache=True)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 11),
             gen_lens=(3, 6), seed=5)
F32 = dict(attn_impl="chunked", cache_dtype="float32",
           compute_dtype="float32")
#: name -> Runtime keywords of the plan
ENGINE_PLANS = {
    "w4a16_packed": dict(quant_backend="w4a16_packed"),
    "w4a16_sensitive_fp": dict(quant_plan="w4a16_sensitive_fp"),
    "mixed_sensitive": dict(quant_plan="mixed_sensitive"),
    "lut4": dict(quant_plan="*=lut4;lm_head=float"),
}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's finished requests and stats under every plan, on one
    set of f32 masters (reduced qwen2-0.5b, 2 layers)."""
    jcfg = jconfigs.get_config(ARCH).reduced(n_layers=2)
    masters = j_init_model(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, kw in ENGINE_PLANS.items():
        jrt = jconfigs.Runtime(**F32, **kw, remat="none", loss_chunk=0)
        params = jplan.pack_for_serving(masters, jcfg, jrt)
        engine = JEngine(jcfg, jrt, jconfigs.ServingConfig(**ENGINE_SV),
                         params=params)
        out[name] = j_run_trace(engine, j_poisson_trace(vocab=jcfg.vocab,
                                                        **TRACE))
    return jax.tree.map(np.asarray, masters), out


@pytest.mark.parametrize("name", sorted(ENGINE_PLANS))
def test_engine_greedy_tokens_identical_under_plans(jax_runs, name):
    masters, runs = jax_runs
    jstats, jfin = runs[name]
    cfg = tconfigs.get_config(ARCH).reduced(n_layers=2)
    rt = tconfigs.Runtime(**F32, **ENGINE_PLANS[name])
    params = tplan.pack_for_serving(params_from_jax(masters, "cpu"), cfg, rt)
    engine = InferenceEngine(cfg, rt, tconfigs.ServingConfig(**ENGINE_SV),
                             params=params, device="cpu")
    tstats, tfin = run_trace(engine, poisson_trace(vocab=cfg.vocab, **TRACE))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    for key in ("prefill_tokens", "decode_tokens", "steps"):
        assert tstats[key] == jstats[key], key


# ------------------------------------------------------------------ CLI ----
@pytest.mark.parametrize("argv,quant", [
    (["--quant", "lut4"], "lut4"),
    (["--quant-plan", "*=w4a16_packed/g32;lm_head=float"],
     "*=w4a16_packed/g32;lm_head=float"),
    (["--quant", "int_sim", "--quant-plan", "mixed_sensitive"],
     "mixed_sensitive"),
])
def test_serve_cli_takes_quant_and_quant_plan(monkeypatch, capsys, argv,
                                              quant):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--layers", "2", "--device",
        "cpu", "--requests", "2", "--prompt-lens", "8", "--gen-lens", "3",
        "--max-ctx", "32", "--num-pages", "16", *argv])
    serve.main()
    report = json.loads(capsys.readouterr().out)
    assert report["quant"] == quant
    assert report["paged"]["requests_finished"] == 2
    assert set(report["kernel_launches"]) == set(ops.launch_counts())
    assert set(report["kernel_launches"].values()) == {0}


# --------------------------------------------------------------- repair ----
def test_params_from_jax_puts_weights_on_the_card_unless_asked():
    """The converter runs on the card by default, like every entry point
    of the port; tests ask for the CPU."""
    default = inspect.signature(params_from_jax).parameters["device"].default
    assert default == "cuda"
    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.arange(4)}}
    cpu = params_from_jax(tree, "cpu")
    assert cpu["a"].device.type == "cpu" and cpu["b"]["c"].dtype == torch.int64
    if torch.cuda.is_available():
        assert params_from_jax(tree)["a"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            params_from_jax(tree)
