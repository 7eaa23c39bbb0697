"""The pipeline's backward (``distributed.pipeline.pipeline_apply``) on 4
gloo ranks, one stage a rank, 8 microbatches: the gradients of
``sum(y * r)`` with respect to the stacked stage parameters and the input,
for the JAX package's own ``tanh(x @ w)`` stages and for a reduced
qwen2-0.5b "A" block (float32) as the stage function.

The truth is the sequential application's gradient (the stages applied
one after another to the whole batch, then ``torch.autograd.grad``).  The
pipeline sums the microbatches' gradients one tick at a time, so it
differs from it by the order of float32 sums only: held to rtol 1e-5 /
atol 1e-6 (tanh) and rtol 1e-4 / atol 1e-5 (the block), as are the
outputs.  Every rank holds the same gradients (the outputs and inputs are
replicated).  The ledger shows the backward's ring shifts and
all-reduces.

``jax.grad`` through the JAX package's ``pipeline_apply`` on an Auto-axes
4-stage mesh is a second reference: its gradients with respect to the
stacked parameters and the input are the sequential ones too, held to the
same bounds (tanh) and, across the two frameworks' float32 block
arithmetic, to rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

CASES = ("tanh", "block")
TOL = {"tanh": dict(rtol=1e-5, atol=1e-6), "block": dict(rtol=1e-4,
                                                         atol=1e-5)}
JAX_TOL = {"tanh": TOL["tanh"], "block": dict(rtol=1e-4, atol=1e-4)}
N_STAGES = 4

JAX_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import Runtime, get_config
from repro.distributed.pipeline import pipeline_apply
from repro.models import init_model
from repro.models.transformer import apply_block

d = sys.argv[1]
stages = Mesh(np.array(jax.devices()[:4]), ("stage",))
cfg = get_config("qwen2-0.5b").reduced(n_layers=4)
rt = Runtime(quant_backend="float", compute_dtype="float32",
             attn_impl="full", remat="none", scan_layers=False)
p = init_model(jax.random.PRNGKey(0), cfg)["layers"]["u0"]
flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(p)[0]}
with np.load(f"{d}/block_x.npz") as z:
    np.savez(f"{d}/block_in.npz", x=z["x"], r=z["r"], **flat)


def block(p, xb):
    B, S = xb.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    return apply_block("A", p, xb, cfg, rt, pos)[0]


fns = {"tanh": lambda w, xb: jnp.tanh(xb @ w), "block": block}
for case in ("tanh", "block"):
    with np.load(f"{d}/{case}_in.npz") as z:
        x, r = jnp.asarray(z["x"]), jnp.asarray(z["r"])
        ws = (jnp.asarray(z["ws"]) if case == "tanh" else
              jax.tree.map(jnp.asarray, p))

    def loss(ws, x):
        y = pipeline_apply(fns[case], ws, x, mesh=stages, n_micro=8)
        return jnp.sum(y * r)

    gw, gx = jax.grad(loss, argnums=(0, 1))(ws, x)
    gflat = ({"ws": np.asarray(gw)} if case == "tanh" else
             {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
              for kp, v in jax.tree_util.tree_flatten_with_path(gw)[0]})
    np.savez(f"{d}/{case}_jax.npz", gx=np.asarray(gx),
             **{"g/" + k: v for k, v in gflat.items()})
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe_grad")
    rng = np.random.default_rng(7)
    f32 = np.float32
    np.savez(d / "tanh_in.npz",
             ws=(rng.standard_normal((N_STAGES, 16, 16)) * 0.3).astype(f32),
             x=rng.standard_normal((32, 16)).astype(f32),
             r=rng.standard_normal((32, 16)).astype(f32))
    np.savez(d / "block_x.npz",
             x=rng.standard_normal((8, 8, 64)).astype(f32),
             r=rng.standard_normal((8, 8, 64)).astype(f32))
    W.run_jax(JAX_SCRIPT, [d])
    W.spawn(W.pipe_grad_worker, N_STAGES, d, str(d), CASES)
    return d


def _sequential(d, case):
    """The sequential application's outputs and gradients (x, then the
    stacked parameters by path)."""
    from repro_torch.optim.adamw import tree_map

    fn = W.pipe_stage(case)
    full = tree_map(torch.from_numpy, W.load_npz(d / f"{case}_in.npz"))
    x, r = full.pop("x"), full.pop("r")
    ws = full["ws"] if case == "tanh" else full
    flat = W.flatten(ws) if isinstance(ws, dict) else {"ws": ws}
    live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = W.unflatten(live) if isinstance(ws, dict) else live["ws"]
    xl = x.detach().requires_grad_(True)
    y = xl
    for s in range(N_STAGES):
        y = fn(tree_map(lambda v: v[s], tree) if isinstance(tree, dict)
               else tree[s], y)
    grads = torch.autograd.grad(W.pipe_loss(y, r), [xl, *live.values()])
    return (y.detach().numpy(), grads[0].numpy(),
            {k: g.numpy() for k, g in zip(live, grads[1:])})


@pytest.mark.parametrize("case", CASES)
def test_pipeline_gradients_equal_the_sequential_ones(runs, case):
    y, gx, g = _sequential(runs, case)
    ranks = [torch.load(runs / f"{case}_rank{r}.pt", weights_only=False)
             for r in range(N_STAGES)]
    for res in ranks:
        np.testing.assert_allclose(res["y"], y, **TOL[case])
        np.testing.assert_allclose(res["gx"], gx, **TOL[case])
        assert sorted(res["g"]) == sorted(g)
        for k in g:
            np.testing.assert_allclose(res["g"][k], g[k], err_msg=k,
                                       **TOL[case])
    for res in ranks[1:]:
        assert np.array_equal(res["gx"], ranks[0]["gx"])
        for k in g:
            assert np.array_equal(res["g"][k], ranks[0]["g"][k]), k


def test_pipeline_backward_collectives(runs):
    """11 ticks of ring shifts each way and the output all-reduce, then
    one all-reduce each for the input's and the parameter's gradients."""
    res = torch.load(runs / "tanh_rank0.pt", weights_only=False)
    ticks = 8 + N_STAGES - 1
    assert res["log"].count("collective-permute") == 2 * ticks
    assert res["log"].count("all-reduce") == 1 + 2


@pytest.mark.parametrize("case", CASES)
def test_jax_pipeline_gradients(runs, case):
    """``jax.grad`` through the JAX ``pipeline_apply``: the sequential
    gradients of the parameters and the input."""
    _, gx, g = _sequential(runs, case)
    with np.load(runs / f"{case}_jax.npz") as z:
        jgx = z["gx"]
        jg = {k[2:]: z[k] for k in z.files if k.startswith("g/")}
    assert sorted(jg) == sorted(g)
    for k in g:
        np.testing.assert_allclose(jg[k], g[k], err_msg=k, **JAX_TOL[case])
    np.testing.assert_allclose(jgx, gx, **JAX_TOL[case])
