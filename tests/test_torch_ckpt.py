"""Port parity for checkpoints (``repro_torch.checkpoint``) against the JAX
package (``repro.checkpoint``): the substrate's atomic save, keep-last-k
retention, partial saves and `latest_step`; float checkpoints written by
either package restored by the other, every leaf equal exactly; quantized
checkpoints of the same masters with the same keys, dtypes and array bytes
in both packages; a JAX quantized checkpoint served by the port with the
JAX engine's tokens in float32; the plan checks on restore; the lut4 mixed
plan and the expert stacks; `plan_to_dict` against the JAX package's.  The
JAX engines run once per file, in a module-scoped fixture."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro.core.quant_plan as jplan  # noqa: E402
import repro_torch.checkpoint as tck  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.core.quant_plan as tplan  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models.transformer import forward, init_model  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "qwen2-0.5b"
JCFG = jconfigs.get_config(ARCH).reduced(n_layers=2)
CFG = tconfigs.get_config(ARCH).reduced(n_layers=2)
#: float32 activations and KV: the engines' tokens are then the same
F32 = dict(attn_impl="chunked", attn_chunk_q=8, cache_dtype="float32",
           compute_dtype="float32")
JRT_KW = dict(F32, remat="none", loss_chunk=0)
SV = dict(layout="paged", max_batch=3, page_size=4, num_pages=16,
          max_ctx=40, prefix_cache=True)
TRACE = dict(n_requests=4, rate_per_step=0.8, prompt_lens=(5, 11),
             gen_lens=(3, 6), seed=5)
MIXED_LUT4 = "ffn.*=lut4;attn.*=int_sim;lm_head=float;*=w4a16"
#: the plans the quantized checkpoints are written under: uniform
#: pre-packed W4A4, the mixed deployment plan (block 0's attention float,
#: so layers are packed one by one), and the lut4 mixed plan
CKPT_PLANS = ("serve_w4a4", "mixed_sensitive", MIXED_LUT4)


def _masters(seed=0):
    """JAX f32 masters as numpy, and the same on the port's CPU."""
    jp = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(seed),
                                               JCFG))
    return jp, params_from_jax(jp, "cpu")


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_t(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_t(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    return t.numpy()


def _read_step(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


# ------------------------------------------------------------ substrate ----
def test_roundtrip_keep_last_k_and_dtypes(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}
    mgr = tck.CheckpointManager(d, save_every=1, keep=2)
    for step in (1, 2, 3):
        mgr.maybe_save(step, {"a": tree["a"] * step,
                              "nested": {"b": tree["nested"]["b"] * step,
                                         "c": tree["nested"]["c"] * step}})
    assert mgr.latest() == 3
    restored, step = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(6).reshape(2, 3) * 3)
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"],
                       torch.full((4,), 3.0, dtype=torch.bfloat16))
    assert restored["nested"]["c"].dtype == torch.int32
    assert int(restored["nested"]["c"]) == 9
    # keep=2: step 1 is gone
    assert not os.path.exists(os.path.join(d, "step_00000001"))
    manifest, arrays = _read_step(os.path.join(d, "step_00000003"))
    assert manifest["dtypes"]["nested/b"] == "bfloat16"
    assert arrays["nested/b"].dtype == np.float32     # npz has no bf16


def test_partial_saves_ignored_and_collected(tmp_path):
    d = str(tmp_path)
    assert tck.latest_step(d + "/missing") is None
    assert tck.latest_step(d) is None
    tck.save_checkpoint(d, 5, {"x": torch.zeros(3)})
    os.makedirs(os.path.join(d, "step_00000009.tmp_dead"))
    os.makedirs(os.path.join(d, "step_00000010"))     # no manifest
    assert tck.latest_step(d) == 5
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp_dead"))
    # the JAX package reads the same directory the same way
    assert jck.latest_step(d) == 5


def test_restore_places_leaves_as_like_and_refuses_shardings(tmp_path):
    d = str(tmp_path)
    tck.save_checkpoint(d, 1, {"w": torch.linspace(-1, 1, 8)})
    like = {"w": torch.zeros(8, dtype=torch.float64)}
    out = tck.restore_checkpoint(d, 1, like)
    assert out["w"].dtype == torch.float64 and out["w"].device == like[
        "w"].device
    assert torch.equal(out["w"], torch.linspace(-1, 1, 8).double())
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(d, 1, {"w": torch.zeros(4)})
    # a sharding cuts each full leaf to this rank's shard, which must be
    # the `like` leaf's shape
    class FirstHalf:
        def local(self, t):
            return t[: t.shape[0] // 2]

    half, _ = tck.CheckpointManager(d).restore(
        {"w": torch.zeros(4)}, shardings={"w": FirstHalf()})
    assert torch.equal(half["w"], torch.linspace(-1, 1, 8)[:4])
    with pytest.raises(ValueError, match="shape"):
        tck.CheckpointManager(d).restore(like, shardings={"w": FirstHalf()})


def test_derived_leaves_are_never_written(tmp_path):
    from repro_torch.models.transformer import with_layer_views

    _, masters = _masters()
    rt = tconfigs.Runtime(quant_backend="w4a4_packed", **F32)
    served = with_layer_views(tplan.pack_for_serving(masters, CFG, rt), CFG)
    path = tck.save_checkpoint(str(tmp_path), 0, served)
    manifest, _ = _read_step(path)
    assert not [k for k in manifest["keys"]
                if "packed_km" in k or "layer_views" in k]
    assert any(k.endswith("/packed") for k in manifest["keys"])


# -------------------------------------------------- float, both packages ----
def test_jax_train_checkpoint_restores_in_the_port(tmp_path):
    """The JAX trainer's state (params, both moments, both steps), one
    leaf in bf16, saved by the JAX package and restored by the port."""
    state = j_init_train_state(jax.random.PRNGKey(3), JCFG)
    state["params"]["final_norm"] = (
        state["params"]["final_norm"] * 1.5).astype(jnp.bfloat16)
    state["opt"]["mu"] = jax.tree.map(lambda x: x + 0.25, state["opt"]["mu"])
    state["step"] = jnp.asarray(7, jnp.int32)
    jck.save_checkpoint(str(tmp_path), 7, state)
    want = jax.tree.map(np.asarray, state)
    like = train_state_from_jax(jax.tree.map(np.zeros_like, want), "cpu")
    got = tck.restore_checkpoint(str(tmp_path), 7, like)
    fj, ft = _flat_t(want), _flat_t(got)
    assert sorted(fj) == sorted(ft)
    for k, leaf in fj.items():
        assert str(ft[k].dtype) == f"torch.{leaf.dtype.name}", k
        want_k = (leaf.astype(np.float32) if leaf.dtype.name == "bfloat16"
                  else leaf)
        np.testing.assert_array_equal(_np(ft[k]), want_k, err_msg=k)


def test_port_train_checkpoint_restores_in_jax(tmp_path):
    from repro_torch.launch.steps import init_train_state

    gen = torch.Generator().manual_seed(11)
    state = init_train_state(gen, CFG)
    state["params"]["final_norm"] = state["params"]["final_norm"].to(
        torch.bfloat16)
    state["opt"]["nu"]["embed"]["tok"] += 0.5
    state["step"] = torch.tensor(4, dtype=torch.int32)
    tck.save_checkpoint(str(tmp_path), 4, state)
    like = jax.tree.map(
        jnp.zeros_like, j_init_train_state(jax.random.PRNGKey(0), JCFG))
    like["params"]["final_norm"] = like["params"]["final_norm"].astype(
        jnp.bfloat16)
    got = jax.tree.map(np.asarray, jck.restore_checkpoint(str(tmp_path), 4,
                                                          like))
    fj, ft = _flat_t(got), _flat_t(state)
    assert sorted(fj) == sorted(ft)
    for k, leaf in fj.items():
        np.testing.assert_array_equal(np.asarray(leaf, np.float32)
                                      if leaf.dtype.name == "bfloat16"
                                      else leaf, _np(ft[k]), err_msg=k)
    assert got["params"]["final_norm"].dtype.name == "bfloat16"
    assert int(got["step"]) == 4 and got["step"].dtype == np.int32


# ---------------------------------------------- quantized, both packages ----
@pytest.mark.parametrize("spec", CKPT_PLANS)
def test_save_quantized_same_keys_dtypes_and_bytes(tmp_path, spec):
    jp, tp = _masters(seed=2)
    jpath = jck.save_quantized(str(tmp_path / "j"), 0,
                               jax.tree.map(jnp.asarray, jp), JCFG,
                               plan=jplan.get_plan(spec))
    tpath = tck.save_quantized(str(tmp_path / "t"), 0, tp, CFG,
                               plan=tplan.get_plan(spec))
    jm, ja = _read_step(jpath)
    tm, ta = _read_step(tpath)
    for key in ("keys", "shapes", "dtypes", "format", "arch", "plan",
                "site_backends", "process_count", "step"):
        assert tm[key] == jm[key], key
    assert list(ta) == list(ja)                      # npz order too
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        assert ta[k].tobytes() == ja[k].tobytes(), k
    assert "uint8" in tm["dtypes"].values()


@pytest.fixture(scope="module")
def jax_quantized(tmp_path_factory):
    """Per plan: a JAX quantized checkpoint's directory and the JAX
    engine's finished requests served from it."""
    out = {}
    masters = j_init_model(jax.random.PRNGKey(0), JCFG)
    for spec in ("serve_w4a4", "mixed_sensitive"):
        d = str(tmp_path_factory.mktemp(spec))
        jrt = jconfigs.Runtime(quant_plan=spec, **JRT_KW)
        jck.save_quantized(d, 0, masters, JCFG, rt=jrt)
        params, _ = jck.restore_quantized(d, cfg=JCFG, rt=jrt)
        engine = JEngine(JCFG, jrt, jconfigs.ServingConfig(**SV),
                         params=params)
        out[spec] = (d, j_run_trace(engine, j_poisson_trace(
            vocab=JCFG.vocab, **TRACE))[1])
    return out


@pytest.mark.parametrize("spec", ["serve_w4a4", "mixed_sensitive"])
def test_jax_quantized_checkpoint_served_by_the_port(jax_quantized, spec):
    d, jfin = jax_quantized[spec]
    rt = tconfigs.Runtime(quant_plan=spec, **F32)
    params, manifest = tck.restore_quantized(d, cfg=CFG, rt=rt, device="cpu")
    assert manifest["format"] == tck.QUANTIZED_FORMAT
    assert isinstance(params["layers"], list) == (spec == "mixed_sensitive")
    engine = InferenceEngine(CFG, rt, tconfigs.ServingConfig(**SV),
                             params=params, device="cpu")
    _, tfin = run_trace(engine, poisson_trace(vocab=CFG.vocab, **TRACE))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]


def test_mismatched_plan_raises(tmp_path):
    _, tp = _masters()
    d = str(tmp_path)
    tck.save_quantized(d, 0, tp, CFG, plan=tplan.get_plan("mixed_sensitive"))
    tck.restore_quantized(d, cfg=CFG, device="cpu",
                          rt=tconfigs.Runtime(quant_plan="mixed_sensitive"))
    # a packed site resolved to another backend: named per site
    with pytest.raises(ValueError, match="does not match"):
        tck.restore_quantized(d, cfg=CFG, device="cpu",
                              rt=tconfigs.Runtime(quant_backend="w4a4_packed"))
    # the same site backends, another plan: the whole-plan rule check
    other = "*=int_sim;ffn.*=w4a16/a16;block[0].attn.*=float;lm_head=float;" \
            "attn.wo=int_sim"
    with pytest.raises(ValueError, match="does not match the plan"):
        tck.restore_quantized(d, cfg=CFG, device="cpu",
                              rt=tconfigs.Runtime(quant_plan=other))
    # a float checkpoint is not a quantized one
    tck.save_checkpoint(str(tmp_path / "f"), 0, tp)
    with pytest.raises(ValueError, match="not a quantized checkpoint"):
        tck.restore_quantized(str(tmp_path / "f"), device="cpu")


def test_lut4_mixed_plan_roundtrip(tmp_path):
    """After the JAX package's mixed lut4 roundtrip: the manifest's site
    backends, logits bit-equal to the in-memory pack, a per-site refusal
    naming lut4."""
    _, tp = _masters()
    rt = tconfigs.Runtime(quant_plan=MIXED_LUT4, **F32)
    tck.save_quantized(str(tmp_path), 0, tp, CFG, rt=rt)
    restored, manifest = tck.restore_quantized(str(tmp_path), cfg=CFG, rt=rt,
                                               device="cpu")
    sb = manifest["site_backends"]
    assert sb.get("block[0].ffn.w_in") == "lut4"
    assert sb.get("block[0].attn.qkv") == "int_sim"
    assert "lm_head" not in sb
    ref = tplan.plan_pack_tree(tp, CFG, tplan.get_plan(MIXED_LUT4),
                               backends=tplan.CKPT_PACKED,
                               scale_dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab, (1, 8)).astype(np.int32))
    la = forward(restored, toks, CFG, rt)[0]
    lb = forward(ref, toks, CFG, rt)[0]
    assert torch.equal(la, lb)
    # the twins rebuilt as on the card serve the same logits
    assert torch.equal(forward(prepack_tree(restored), toks, CFG, rt)[0], la)
    with pytest.raises(ValueError, match="lut4"):
        tck.restore_quantized(
            str(tmp_path), cfg=CFG, device="cpu",
            rt=tconfigs.Runtime(quant_plan="ffn.*=int_sim;attn.*=int_sim;"
                                "lm_head=float;*=w4a16"))


@pytest.mark.parametrize("spec,packed", [("*=int_sim;lm_head=float", False),
                                         ("serve_w4a4", True)])
def test_expert_stacks_pack_as_live_serving(tmp_path, spec, packed):
    """After the JAX package's expert-stack rule: on-the-fly plans keep the
    experts' masters, pre-packing plans pack them; the port's checkpoint
    holds the JAX package's keys and bytes and restores bit for bit."""
    jmoe = next(c for c in sorted(jconfigs.REGISTRY.values(),
                                  key=lambda c: c.name)
                if c.n_experts).reduced()
    moe = tconfigs.get_config(jmoe.name).reduced()
    jp = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0), jmoe))
    tp = params_from_jax(jp, "cpu")
    jpath = jck.save_quantized(str(tmp_path / "j"), 0,
                               jax.tree.map(jnp.asarray, jp), jmoe,
                               plan=jplan.get_plan(spec), min_size=1)
    tpath = tck.save_quantized(str(tmp_path / "t"), 0, tp, moe,
                               plan=tplan.get_plan(spec), min_size=1)
    (jm, ja), (tm, ta) = _read_step(jpath), _read_step(tpath)
    assert tm["keys"] == jm["keys"] and tm["dtypes"] == jm["dtypes"]
    for k in ja:
        assert ta[k].tobytes() == ja[k].tobytes(), k
    restored, _ = tck.restore_quantized(str(tmp_path / "t"), device="cpu")
    blocks = (restored["layers"][0] if isinstance(restored["layers"], list)
              else restored["layers"]["u0"])
    assert isinstance(blocks["moe"]["experts"]["w_in"], dict) == packed
    ref = tplan.plan_pack_tree(tp, moe, tplan.get_plan(spec),
                               backends=tplan.CKPT_PACKED, min_size=1,
                               scale_dtype=torch.bfloat16)
    fr, fp = _flat_t(restored), _flat_t(ref)
    assert sorted(fr) == sorted(fp)
    for k in fr:
        assert fr[k].dtype == fp[k].dtype and torch.equal(fr[k], fp[k]), k


@pytest.mark.parametrize("spec", sorted(tplan.PRESETS) + [
    "block[0].*=float;ffn.*=w4a16/g128;*=int_sim/a8;lm_head=w4a4_packed"])
def test_plan_to_dict_equals_the_jax_package(spec):
    t = tplan.plan_to_dict(tplan.get_plan(spec))
    assert t == jplan.plan_to_dict(jplan.get_plan(spec))
    assert json.loads(json.dumps(t)) == t
    assert tplan.plan_from_dict(t) == tplan.get_plan(spec)


def test_serve_cli_quantized_ckpt(tmp_path, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--layers", "2", "--device",
                "cpu", "--quant-plan", "mixed_sensitive", "--quantized-ckpt",
                "--ckpt-dir", str(tmp_path), "--requests", "3",
                "--prompt-lens", "8", "--gen-lens", "4"])
    report = json.loads(capsys.readouterr().out)["quantized_ckpt"]
    assert report["bit_identical_logits"] and report["tokens_match"]
    assert report["manifest_format"] == tck.QUANTIZED_FORMAT
    assert 0 < report["quantized_bytes"] < report["float_master_bytes"]
    assert os.path.isdir(tmp_path / "q" / "step_00000000")
    assert report["save_s"] > 0 and report["load_s"] > 0
