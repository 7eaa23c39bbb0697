"""The MoE block's expert-parallel path and GPipe pipelining on gloo ranks
(CPU) against the port's single process and the JAX package's
``shard_map`` paths on the same Auto-axes meshes (one subprocess with 4
fake host devices for the file).

The JAX tests' reduced arctic-480b and llama4-maverick (8 experts,
d_model 64, d_ff_expert 64, capacity factor 64, float32) on a (2, 2)
mesh: the output within rtol 2e-4 / atol 2e-5, the aux (a per-data-shard
estimator in both packages) within rtol 0.1, llama4's gradients of
sum(y**2) within rtol 5e-4 / atol 1e-5: the JAX package's own bounds
(``tests/test_distributed.py``, which takes gradients of llama4 only).
arctic's gradients (a batch four times larger, entries up to ~260) are
held to rtol 5e-4 with atol 1e-6 of the leaf's largest entry: float32
rounding of sums that large leaves ~3e-5 on entries near zero.  The
pipeline: 4 stages, 8 microbatches of 4 x 16, within rtol 2e-5 / atol
2e-6 of sequential application and of the JAX package's
``pipeline_apply``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
#: x's shape per config, as the JAX tests draw it
X_SHAPE = {"arctic-480b": (8, 16, 64), "llama4-maverick-400b-a17b": (4, 8, 64)}
#: the config whose gradients the JAX package's own test bounds
GRAD_ARCHS_JAX = ("llama4-maverick-400b-a17b",)

JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import Runtime, get_config
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import mesh_context
from repro.models.moe import apply_moe, init_moe

d = sys.argv[1]
shapes = json.loads(sys.argv[2])
rt = Runtime(quant_backend="float", compute_dtype="float32")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for arch, shape in shapes.items():
    cfg = get_config(arch).reduced(n_experts=8, d_model=64, d_ff_expert=64,
                                   capacity_factor=64.0)
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), tuple(shape))
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    np.savez(f"{d}/{arch}_moe.npz", x=np.asarray(x), **flat)

    def loss(p, x):
        return jnp.sum(apply_moe(p, x, cfg, rt)[0] ** 2)

    with mesh_context(mesh):
        y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, rt))(p, x)
        g = jax.jit(jax.grad(loss))(p, x)
    gflat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    np.savez(f"{d}/{arch}_jax.npz", y=np.asarray(y), aux=np.asarray(aux),
             **{"g/" + k: v for k, v in gflat.items()})

stages = Mesh(np.array(jax.devices()[:4]), ("stage",))
ws = jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16)) * 0.3
x = jax.random.normal(jax.random.PRNGKey(1), (8 * 4, 16))
y = pipeline_apply(lambda w, xb: jnp.tanh(xb @ w), ws, x, mesh=stages,
                   n_micro=8)
np.savez(f"{d}/pipe.npz", ws=np.asarray(ws), x=np.asarray(x),
         y=np.asarray(y))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("dist_moe")
    W.run_jax(JAX_SCRIPT, [d, json.dumps(X_SHAPE)])
    W.spawn(W.moe_pipe_worker, 4, d, str(d))
    return d, torch.load(d / "moe_pipe.pt", weights_only=False)


def _local(d, arch):
    """The port's single-device MoE block on the JAX parameters: (y, aux,
    the gradients of sum(y**2))."""
    from repro_torch.configs import Runtime
    from repro_torch.launch.steps import _like
    from repro_torch.models.moe import apply_moe
    from repro_torch.optim.adamw import tree_leaves, tree_map

    full = tree_map(torch.from_numpy, W.load_npz(d / f"{arch}_moe.npz"))
    x = full.pop("x")
    live = tree_map(lambda p: p.detach().requires_grad_(True), full)
    y, aux = apply_moe(live, x, W.moe_cfg(arch), Runtime(**W.MOE_RT))
    grads = torch.autograd.grad(torch.sum(y ** 2), tree_leaves(live))
    return (y.detach().numpy(), float(aux.detach()),
            W.to_numpy(_like(live, iter(grads))))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mesh_output_matches_local_and_jax_shard_map(runs, arch):
    d, res = runs
    y_local, aux_local, _ = _local(d, arch)
    jax_out = np.load(d / f"{arch}_jax.npz")
    mesh = res[arch]
    np.testing.assert_allclose(mesh["y"], y_local, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(mesh["y"], jax_out["y"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(mesh["aux"], aux_local, rtol=0.1)
    np.testing.assert_allclose(mesh["aux"], float(jax_out["aux"]), rtol=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mesh_gradients_match_local_and_jax_shard_map(runs, arch):
    d, res = runs
    _, _, g_local = _local(d, arch)
    jax_out = np.load(d / f"{arch}_jax.npz")
    got = res[arch]["grads"]
    assert sorted(got) == sorted(g_local)
    for k, want in g_local.items():
        atol = 1e-5 if arch in GRAD_ARCHS_JAX else 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(got[k], want, rtol=5e-4, atol=atol,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], jax_out["g/" + k], rtol=5e-4,
                                   atol=atol, err_msg=k)


def test_moe_mesh_gathers_data_sharded_experts():
    """The rules shard the experts on model and their F axis on data, so
    the mesh path's FSDP gather is exercised (not a no-op)."""
    from repro_torch.distributed.sharding import Mesh, make_param_shardings

    cfg = W.moe_cfg("arctic-480b")
    F, D, E = cfg.d_ff_expert, cfg.d_model, cfg.n_experts
    leaves = {"experts": {"w_in": torch.zeros(E, D, F),
                          "w_out": torch.zeros(E, F, D)}}
    specs = make_param_shardings(leaves, Mesh({"data": 2, "model": 2}))
    assert specs["experts"] == {"w_in": ("model", None, "data"),
                                "w_out": ("model", "data", None)}


def test_pipeline_matches_sequential_and_jax(runs):
    d, res = runs
    with np.load(d / "pipe.npz") as z:
        ws, x, y_jax = z["ws"], z["x"], z["y"]
    y_ref = torch.from_numpy(x)
    for s in range(4):
        y_ref = torch.tanh(y_ref @ torch.from_numpy(ws[s]))
    np.testing.assert_allclose(res["pipe"], y_ref.numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(res["pipe"], y_jax, rtol=2e-5, atol=2e-6)
