"""The W4A4-packed forward on a tensor-parallel mesh: the contiguous prefill
and decode steps of reduced qwen2-0.5b and qwen3-4b (2 layers, so every
projection is packed) with ``quant_backend="w4a4_packed"`` in float32 on
(1, 2) and (1, 4) gloo meshes, against the port's single process and the
JAX package's jitted steps on the same Auto-axes mesh (4 fake host
devices, one subprocess for the file).

Column-parallel projections run the fused GEMM on each rank's columns; the
row-parallel ones (``wo``, ``ffn/w_out``) quantize with the global row
amax and sum the integer partials before the scales, so they equal the
single-process GEMM bit for bit (held here through the plain versions).
Greedy tokens are equal; logits within 1e-4 of the JAX package's (f32
rounding of the float ops around the exact integer GEMMs).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

ARCHS = ("qwen2-0.5b", "qwen3-4b")
TPS = (2, 4)
LOGIT_ATOL = 1e-4

JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import Runtime, get_config
from repro.core.quant_plan import pack_for_serving
from repro.distributed.sharding import (make_param_shardings, mesh_context,
                                        specs_to_shardings)
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import init_caches, init_model

d, rt_kw = sys.argv[1], json.loads(sys.argv[2])
rt = Runtime(**rt_kw)
for arch in ("qwen2-0.5b", "qwen3-4b"):
    cfg = get_config(arch).reduced(n_layers=2)
    params = pack_for_serving(init_model(jax.random.PRNGKey(0), cfg), cfg, rt)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(f"{d}/{arch}_params.npz", **flat)
    toks = np.load(f"{d}/{arch}_tokens.npy")
    B, S = toks.shape
    for tp in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                    ("data", "model"))
        with mesh_context(mesh):
            p = jax.device_put(params, specs_to_shardings(
                make_param_shardings(params, mesh), mesh))
            pre = jax.jit(make_prefill_step(cfg, rt))
            dec = jax.jit(make_decode_step(cfg, rt))
            logits, caches = pre(p, jnp.asarray(toks),
                                 init_caches(cfg, rt, B, 16))
            out = [np.asarray(logits)]
            for i in range(3):
                tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
                pos = jnp.full((B, 1), S + i, jnp.int32)
                logits, caches = dec(p, tok[:, None], caches, pos)
                out.append(np.asarray(logits))
        np.save(f"{d}/{arch}_jax_tp{tp}.npy", np.stack(out))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_w4a4")
    rng = np.random.default_rng(2)
    for arch in ARCHS:
        np.save(d / f"{arch}_tokens.npy",
                rng.integers(0, 256, (2, 8)).astype(np.int32))
    W.run_jax(JAX_SCRIPT, [d, json.dumps(W.W4A4_RT)])
    for tp in TPS:
        jobs = [(str(d / f"{a}_tp{tp}.pt"), a, tp,
                 str(d / f"{a}_params.npz"), str(d / f"{a}_tokens.npy"))
                for a in ARCHS]
        W.spawn(W.w4a4_worker, tp, d, jobs)
    return d


def _single(d, arch):
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.qlinear import prepack_tree, qdense

    cfg = get_config(arch).reduced(n_layers=2)
    rt = Runtime(**W.W4A4_RT)
    params = prepack_tree(params_from_jax(
        W.load_npz(d / f"{arch}_params.npz"), "cpu"))
    toks = torch.from_numpy(np.load(d / f"{arch}_tokens.npy"))
    logits = [t.numpy() for t in W.w4a4_steps(params, cfg, rt, toks)]
    layer = params["layers"]["u0"]
    gemm = {}
    for name, w, K in (("wo", layer["attn"]["wo"], cfg.n_heads * cfg.hd),
                       ("w_out", layer["ffn"]["w_out"], cfg.d_ff)):
        w0 = {k: v[0] for k, v in w.items()}
        gemm[name] = qdense(w0, W.row_gemm_input(K), rt.quant_cfg(cfg, "x")
                            ).numpy()
    return cfg, logits, gemm


def _greedy(logits, vocab):
    return [np.argmax(l[:, :vocab], -1).tolist() for l in logits]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_tp_steps_match_single_process_and_jax_mesh(runs, arch, tp):
    cfg, single, _ = _single(runs, arch)
    mesh = torch.load(runs / f"{arch}_tp{tp}.pt", weights_only=False)
    jax_mesh = np.load(runs / f"{arch}_jax_tp{tp}.npy")
    want = _greedy(single, cfg.vocab)
    assert _greedy(mesh["logits"], cfg.vocab) == want
    assert _greedy(list(jax_mesh), cfg.vocab) == want
    for got, ref, mine in zip(mesh["logits"], jax_mesh, single):
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(got, mine, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_row_parallel_gemm_is_bit_equal(runs, arch, tp):
    """Layer 0's ``wo`` (K = H * hd, tp rows each) and ``ffn/w_out``
    (K = d_ff): global-amax quantize, integer partials summed over
    ``model``, then the scales: the single-process GEMM's bits."""
    _, _, single = _single(runs, arch)
    mesh = torch.load(runs / f"{arch}_tp{tp}.pt", weights_only=False)
    for name in ("wo", "w_out"):
        assert np.array_equal(mesh[name], single[name]), name


def test_inconsistent_packed_shards_are_refused_at_placement():
    """A packed weight whose nibble pairs the rules would place apart from
    their scales (N / 2 not divisible where N is) is refused when it is
    placed, with a clear error, before any kernel sees it."""
    from repro_torch.distributed.sharding import _check_packed

    packed = {"packed": torch.zeros((8, 3), dtype=torch.uint8),
              "scale": torch.zeros((1, 6))}
    specs = {"packed": (None, None), "scale": (None, "model")}
    with pytest.raises(ValueError, match="inconsistently"):
        _check_packed({"wq": packed}, {"wq": specs})
