"""Port parity for the MoE block (``repro_torch.models.moe``, the
single-device path) and the MoE configs arctic-480b (top-2 beside a dense
residual FFN) and llama4-maverick (top-1 beside a shared expert), the JAX
package and the port on the same weights and inputs.

  (a) ``_capacity`` over a grid of T, k and E;
  (b) ``_moe_shard`` on reduced arctic and llama4, float32, with packed
      (W4A4 serving) and fake-quant experts, on a batch whose router is
      skewed so that tokens drop: the dispatched buffers ``[E, C, D]``
      (which token sits at which expert and rank) equal exactly, as do the
      expert ids, the ranks and the dropped set the port reports against
      ``jax.lax.top_k`` and a numpy count; y within 1e-5, aux within 1e-6;
      with fewer assignments than experts only the T * k most-used experts
      run, and y is still the JAX package's;
  (c) a row of equal router logits routes to the lowest expert ids, as
      ``jax.lax.top_k`` breaks ties;
  (d) the sites: ``block_leaf_sites`` and the plan packer's site log equal
      the JAX package's; the port's packer gives the JAX package's bytes
      and scales for the expert stacks, and no K-major twin;
      ``convert.params_from_jax`` carries the router and expert leaves; the
      port's init draws the JAX package's tree;
  (e) reduced arctic and llama4 served end to end by both engines (W4A4
      weights, float32, the paged bucketed step): greedy tokens equal.
"""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.core import quant_plan as jplan  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.api import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serving.api import run_trace as j_run_trace  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.engine import build_params as j_build_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant_plan as tplan  # noqa: E402
from repro_torch.core.qlinear import prepack_tree  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.api import poisson_trace, run_trace  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    InferenceEngine, build_params)

ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
T_TOKENS = 96


def _cfgs(arch, **kw):
    return (jconfigs.get_config(arch).reduced(**kw),
            tconfigs.get_config(arch).reduced(**kw))


# ----------------------------------------------------- (a) capacity ----
def test_capacity_equals_the_jax_package():
    jcfg, cfg = _cfgs("arctic-480b")
    for T, k, E in itertools.product((1, 7, 8, 64, 129, 2048),
                                     (1, 2, 4), (8, 16, 128)):
        jc = dataclasses.replace(jcfg, top_k=k, n_experts=E)
        tc = dataclasses.replace(cfg, top_k=k, n_experts=E)
        assert tmoe._capacity(T, tc) == jmoe._capacity(T, jc), (T, k, E)


# -------------------------------------------------- (b) _moe_shard ----
def _moe_inputs(cfg, seed):
    """Router, float expert masters and xf [T, D], the router skewed so
    that expert 0 takes most tokens (and drops past its capacity)."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    u = rng.standard_normal(D).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) / np.sqrt(D)
    router[:, 0] += u / np.linalg.norm(u)
    xf = (rng.standard_normal((T_TOKENS, D)) + 0.5 * u).astype(np.float32)
    experts = {"w_in": rng.standard_normal((E, D, F)) / np.sqrt(D),
               "w_out": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if cfg.ffn_type == "swiglu":
        experts["w_gate"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    return router, {k: v.astype(np.float32) for k, v in experts.items()}, xf


def _pack_experts_jax(experts, jcfg):
    qc = jconfigs.Runtime(quant_backend="w4a4_packed").quant_cfg(
        jcfg, "moe.experts")
    from repro.core.qlinear import pack_weight_nd

    qc = dataclasses.replace(qc, group_size=0)
    return {k: pack_weight_nd(jnp.asarray(v), qc) for k, v in experts.items()}


def _routing_numpy(idx, T, k, E, C):
    """(rank of each flat assignment in token order, dropped mask) from
    the expert ids alone."""
    flat = idx.reshape(-1)
    rank = np.zeros(T * k, np.int64)
    seen = np.zeros(E, np.int64)
    for a, e in enumerate(flat):
        rank[a] = seen[e]
        seen[e] += 1
    return rank, rank >= C


@pytest.fixture(params=[(a, q) for a in ARCHS
                        for q in ("w4a4_packed", "fake_quant")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def shard_pair(request, monkeypatch):
    """Both packages' `_moe_shard` on the same inputs, float32, their
    dispatched buffers captured."""
    arch, quant = request.param
    jcfg, cfg = _cfgs(arch)
    router, experts, xf = _moe_inputs(cfg, 11)
    jrt = jconfigs.Runtime(quant_backend=quant, compute_dtype="float32")
    rt = tconfigs.Runtime(quant_backend=quant, compute_dtype="float32")
    jexp = (_pack_experts_jax(experts, jcfg) if quant == "w4a4_packed"
            else {k: jnp.asarray(v) for k, v in experts.items()})
    texp = params_from_jax(jax.tree.map(np.asarray, jexp), "cpu")
    bufs = {}

    def capture(name, fn):
        def wrapped(buf, *a, **kw):
            bufs[name] = np.asarray(buf)
            return fn(buf, *a, **kw)
        return wrapped

    monkeypatch.setattr(jmoe, "_expert_ffn",
                        capture("jax", jmoe._expert_ffn))
    monkeypatch.setattr(tmoe, "_expert_ffn",
                        capture("port", tmoe._expert_ffn))
    yj, auxj = jmoe._moe_shard(jnp.asarray(xf), jnp.asarray(router), jexp,
                               e_start=0, n_local=jcfg.n_experts, cfg=jcfg,
                               rt=jrt)
    route = {}
    yt, auxt = tmoe._moe_shard(torch.from_numpy(xf), torch.from_numpy(router),
                               texp, e_start=0, n_local=cfg.n_experts,
                               cfg=cfg, rt=rt, dispatch=route)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    return dict(cfg=cfg, yj=np.asarray(yj), auxj=np.asarray(auxj),
                yt=yt.numpy(), auxt=auxt.numpy(), bufs=bufs, route=route,
                jidx=np.asarray(jidx))


def test_moe_shard_dispatches_as_the_jax_package(shard_pair):
    p, cfg = shard_pair, shard_pair["cfg"]
    T, k, E = T_TOKENS, cfg.top_k, cfg.n_experts
    C = tmoe._capacity(T, cfg)
    np.testing.assert_array_equal(p["bufs"]["port"], p["bufs"]["jax"])
    route = {key: val.numpy() for key, val in p["route"].items()}
    np.testing.assert_array_equal(route["idx"], p["jidx"])
    rank, dropped = _routing_numpy(p["jidx"], T, k, E, C)
    order = route["order"]
    np.testing.assert_array_equal(route["rank"], rank[order])
    np.testing.assert_array_equal(~route["local"], dropped[order])
    assert dropped.sum() > 0, "the skewed router should drop tokens"


def test_moe_shard_output_and_aux_match(shard_pair):
    p = shard_pair
    assert np.isfinite(p["yt"]).all()
    np.testing.assert_allclose(p["yt"], p["yj"], rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(p["auxt"], p["auxj"], rtol=0, atol=AUX_ATOL)
    assert p["auxt"].shape == (T_TOKENS,)


def test_expert_chunks_do_not_change_the_result(monkeypatch):
    """Each expert's arithmetic is the same whatever `EXPERT_CHUNK` is."""
    _, cfg = _cfgs("arctic-480b")
    router, experts, xf = _moe_inputs(cfg, 12)
    rt = tconfigs.Runtime(quant_backend="fake_quant", compute_dtype="float32")
    args = (torch.from_numpy(xf), torch.from_numpy(router),
            {k: torch.from_numpy(v) for k, v in experts.items()})
    kw = dict(e_start=0, n_local=cfg.n_experts, cfg=cfg, rt=rt)
    outs = []
    for chunk in (1, 3, cfg.n_experts):
        monkeypatch.setattr(tmoe, "EXPERT_CHUNK", chunk)
        outs.append(tmoe._moe_shard(*args, **kw)[0])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_few_tokens_run_only_their_experts(arch, monkeypatch):
    """T * k < E: only the T * k most-used experts run, and y is the JAX
    package's, which runs all of them."""
    jcfg, cfg = _cfgs(arch)
    router, experts, xf = _moe_inputs(cfg, 14)
    xf = xf[:3]
    jrt = jconfigs.Runtime(quant_backend="w4a4_packed",
                           compute_dtype="float32")
    rt = tconfigs.Runtime(quant_backend="w4a4_packed",
                          compute_dtype="float32")
    jexp = _pack_experts_jax(experts, jcfg)
    texp = params_from_jax(jax.tree.map(np.asarray, jexp), "cpu")
    ran = []
    real = tmoe._dense
    monkeypatch.setattr(tmoe, "_dense", lambda w, ids, *a: (
        ran.append(ids.clone()), real(w, ids, *a))[1])
    yj, _ = jmoe._moe_shard(jnp.asarray(xf), jnp.asarray(router), jexp,
                            e_start=0, n_local=jcfg.n_experts, cfg=jcfg,
                            rt=jrt)
    yt, _ = tmoe._moe_shard(torch.from_numpy(xf), torch.from_numpy(router),
                            texp, e_start=0, n_local=cfg.n_experts, cfg=cfg,
                            rt=rt)
    assert all(len(ids) == 3 * cfg.top_k for ids in ran)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=Y_ATOL)


# ------------------------------------------------------------ (c) ties --
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_logits_route_to_the_lowest_ids(arch):
    jcfg, cfg = _cfgs(arch)
    router, experts, xf = _moe_inputs(cfg, 13)
    xf[:3] = 0.0                                    # uniform probabilities
    router[:, 5] = router[:, 2]                     # experts 2 and 5 tie
    rt = tconfigs.Runtime(quant_backend="float", compute_dtype="float32")
    route = {}
    tmoe._moe_shard(torch.from_numpy(xf), torch.from_numpy(router),
                    {k: torch.from_numpy(v) for k, v in experts.items()},
                    e_start=0, n_local=cfg.n_experts, cfg=cfg, rt=rt,
                    dispatch=route)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    idx = route["idx"].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(idx[:3], np.tile(np.arange(cfg.top_k),
                                                   (3, 1)))
    # expert 5 never wins a place that expert 2, its tie, does not take
    assert not any(5 in row and 2 not in row for row in idx.tolist())


# ----------------------------------------------------------- (d) sites --
@pytest.mark.parametrize("arch", ARCHS)
def test_block_leaf_sites_equal_the_jax_package(arch):
    jcfg, cfg = _cfgs(arch)
    assert tplan.block_leaf_sites("A", cfg) == \
        jplan.block_leaf_sites("A", jcfg)
    assert "moe.experts" in tplan.block_leaf_sites("A", cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_tree_sites_bytes_and_leaves_equal_the_jax_package(arch):
    jcfg, cfg = _cfgs(arch, n_layers=2)
    jrt = jconfigs.Runtime(quant_backend="float", remat="none", loss_chunk=0)
    masters = j_build_params(jcfg, jrt, seed=4)
    tmasters = params_from_jax(jax.tree.map(np.asarray, masters), "cpu")
    spec = "*=w4a4_packed;lm_head=float"
    jlog, tlog = {}, {}
    jpk = jplan.plan_pack_tree(masters, jcfg, jplan.get_plan(spec),
                               site_log=jlog)
    tpk = prepack_tree(tplan.plan_pack_tree(tmasters, cfg,
                                            tplan.get_plan(spec),
                                            site_log=tlog))
    assert tlog == jlog and "block[0].moe.experts" in tlog
    want = params_from_jax(jax.tree.map(np.asarray, jpk), "cpu")
    for name in ("w_in", "w_out"):
        t = tpk["layers"]["u0"]["moe"]["experts"][name]
        w = want["layers"]["u0"]["moe"]["experts"][name]
        assert set(t) == {"packed", "scale"}               # no twin
        for key in ("packed", "scale"):
            assert torch.equal(t[key], w[key]), (name, key)
    assert torch.equal(tpk["layers"]["u0"]["moe"]["router"]["w"],
                       torch.tensor(np.asarray(
                           masters["layers"]["u0"]["moe"]["router"]["w"])))
    side = "dense_ffn" if cfg.moe_dense_ff else "shared"
    assert "packed_km" in tpk["layers"]["u0"][side]["w_in"]
    # the port's own init draws the JAX package's tree
    mine = build_params(cfg, tconfigs.Runtime(quant_backend="float"),
                        device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tmasters)[0]
    assert len(flat) == len(jax.tree_util.tree_flatten_with_path(mine)[0])
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path


# -------------------------------------------------------- (e) engines ---
ENGINE_SV = dict(layout="paged", max_batch=3, page_size=4, num_pages=24,
                 max_ctx=40)
TRACE = dict(n_requests=5, rate_per_step=0.8, prompt_lens=(5, 11),
             gen_lens=(3, 6), seed=12)
F32 = dict(attn_impl="chunked", quant_backend="w4a4_packed",
           compute_dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_runs():
    """{arch: (port weights, JAX stats, JAX finished requests)}, 2 layers,
    W4A4 serving weights (experts packed) in float32."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).reduced(n_layers=2)
        jrt = jconfigs.Runtime(**F32, remat="none", loss_chunk=0)
        jparams = j_build_params(jcfg, jrt, seed=3)
        engine = JEngine(jcfg, jrt, jconfigs.ServingConfig(**ENGINE_SV),
                         params=jparams)
        stats, fin = j_run_trace(engine, j_poisson_trace(vocab=jcfg.vocab,
                                                         **TRACE))
        out[arch] = (prepack_tree(params_from_jax(
            jax.tree.map(np.asarray, jparams), "cpu")), stats, fin)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_engine_tokens_identical_to_jax_engine(jax_runs, arch):
    tparams, jstats, jfin = jax_runs[arch]
    assert "packed" in tparams["layers"]["u0"]["moe"]["experts"]["w_in"]
    cfg = tconfigs.get_config(arch).reduced(n_layers=2)
    engine = InferenceEngine(cfg, tconfigs.Runtime(**F32),
                             tconfigs.ServingConfig(**ENGINE_SV),
                             params=tparams, device="cpu")
    tstats, tfin = run_trace(engine, poisson_trace(vocab=cfg.vocab, **TRACE))
    assert all(r.outcome == "ok" for r in tfin)
    assert [r.tokens for r in tfin] == [r.tokens for r in jfin]
    for key in ("steps", "prefill_tokens", "decode_tokens"):
        assert tstats[key] == jstats[key], key
