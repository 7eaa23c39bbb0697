"""DP x TP training of the port on gloo ranks (CPU) against the JAX package
on the same Auto-axes mesh and against the port's single process.

The JAX reference runs once, in a subprocess with 4 fake host devices, on
a ``jax.sharding.Mesh`` (Auto axes; ``jax.make_mesh`` builds Explicit axes
under jax 0.9, which the package's own ``with_sharding_constraint``
refuses).  Both packages start from the JAX parameters and the same seeded
numpy tokens, in float32 with the float backend.  Tolerances, the JAX
package's own (``tests/test_distributed.py``): the loss within rtol 1e-5
(partial sums over ``model`` and the data ranks' sums add in another
order); the gathered gradients within rtol 1e-5 / atol 1e-7; the
parameters after one train step within 1e-6.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

#: the JAX tests' reduced qwen3-4b: 4 heads over 2 (at tp 4 the KV heads
#: are duplicated), and one with 6 heads over 2, which tp 4 divides
#: neither, so its attention takes "seq" (32 query positions) and "none"
#: (30 of them)
CASES = {
    "qwen3": dict(arch="qwen3-4b", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=256),
    "odd_heads": dict(arch="qwen3-4b", n_layers=2, d_model=64, n_heads=6,
                      n_kv_heads=2, d_ff=128, vocab=256),
    "qwen3_fq": dict(arch="qwen3-4b", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=256),
}
MESHES = {"qwen3": [(2, 2), (1, 4)], "odd_heads": [(1, 4)],
          "qwen3_fq": [(2, 2)]}
TOKENS = {"qwen3": [(8, 33)], "odd_heads": [(8, 33), (8, 31)],
          "qwen3_fq": [(8, 33)]}
MESH_CASES = [(n, s) for n in CASES for s in MESHES[n]]
RT = dict(loss_chunk=0, compute_dtype="float32", quant_backend="float")
#: the trainer's QAT backend: ``wo`` and ``ffn/w_out`` fake-quantize each
#: rank's rows with the whole K's scales and sum the partials.  The JAX
#: package's own loss on a mesh with a ``model`` axis differs from its
#: single-device loss here by 4.7e-5 relative (6.0148702 against 6.0145860
#: on the qwen3_fq tokens; every mesh with data ranks only gives the
#: single-device value): a partial sum added in another order lands a
#: later activation on the other side of a fake-quant rounding boundary.
#: So the fake-quant case is held to the JAX package's single-device loss.
RTS = {n: dict(RT, quant_backend="fake_quant") if n == "qwen3_fq" else RT
       for n in CASES}
JAX_SINGLE_REF = {"qwen3_fq"}
LR = 1e-3

JAX_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import Runtime, get_config
from repro.distributed.sharding import (make_param_shardings, mesh_context,
                                        specs_to_shardings)
from repro.models import init_model, lm_loss

cases, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
d = sys.argv[3]
rts = json.loads(sys.argv[4])
out = {}
for name, kw in cases.items():
    rt = Runtime(**rts[name])
    kw = dict(kw)
    cfg = get_config(kw.pop("arch")).reduced(**kw)
    params = init_model(jax.random.PRNGKey(0), cfg)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(f"{d}/{name}_params.npz", **flat)
    with np.load(f"{d}/{name}_tokens.npz") as z:
        toks = [z[k] for k in sorted(z.files, key=int)]
    out[name] = {}
    for shape in meshes[name]:
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        with mesh_context(mesh):
            sh = specs_to_shardings(make_param_shardings(params, mesh), mesh)
            p = jax.device_put(params, sh)
            fm = jax.jit(lambda p, t: lm_loss(p, t, cfg, rt)[0])
            out[name][str(tuple(shape))] = [float(fm(p, t)) for t in toks]
    fs = jax.jit(lambda p, t: lm_loss(p, t, cfg, rt)[0])
    out[name]["single"] = [float(fs(params, t)) for t in toks]
print(json.dumps(out))
"""


def _single(name, d):
    """The port's single-process loss per token batch, the last batch's
    gradients and one train step."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.steps import _like, make_train_step
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map

    kw = dict(CASES[name])
    cfg = get_config(kw.pop("arch")).reduced(**kw)
    rt = Runtime(**RTS[name])
    params = params_from_jax(W.load_npz(d / f"{name}_params.npz"), "cpu")
    with np.load(d / f"{name}_tokens.npz") as z:
        toks = [torch.from_numpy(z[k]) for k in sorted(z.files, key=int)]
    res = {"losses": []}
    for t in toks:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = lm_loss(live, t, cfg, rt)
        res["losses"].append(float(loss.detach()))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    res["grads"] = W.to_numpy(_like(live, iter(grads)))
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, metrics = make_train_step(cfg, rt, peak_lr=LR, warmup=1)(
        state, toks[-1])
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    res["params_after"] = W.to_numpy(state["params"])
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    rng = np.random.default_rng(1)
    for name, shapes in TOKENS.items():
        np.savez(d / f"{name}_tokens.npz",
                 **{str(i): rng.integers(0, 256, s).astype(np.int32)
                    for i, s in enumerate(shapes)})
    jax_out = json.loads(W.run_jax(
        JAX_SCRIPT, [json.dumps(CASES), json.dumps(MESHES), d,
                     json.dumps(RTS)]).strip().splitlines()[-1])
    jobs = [(str(d / f"{n}_{s[0]}x{s[1]}.pt"), s, CASES[n],
             str(d / f"{n}_params.npz"), str(d / f"{n}_tokens.npz"), RTS[n])
            for n, s in MESH_CASES]
    W.spawn(W.train_worker, 4, d, jobs, LR)
    return {"jax": jax_out,
            "single": {n: _single(n, d) for n in CASES},
            "mesh": {(n, s): torch.load(job[0], weights_only=False)
                     for (n, s), job in zip(MESH_CASES, jobs)}}



@pytest.mark.parametrize("name,shape", MESH_CASES)
def test_mesh_loss_matches_jax_mesh_and_single_process(runs, name, shape):
    """The JAX package's loss on the same mesh (on one device for the
    fake-quant case, `JAX_SINGLE_REF`) and the port's single process."""
    mesh = runs["mesh"][(name, shape)]
    jax_ref = runs["jax"][name][
        "single" if name in JAX_SINGLE_REF else str(tuple(shape))]
    for i, want in enumerate(jax_ref):
        got = mesh[f"loss{i}"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, runs["single"][name]["losses"][i],
                                   rtol=1e-5)


@pytest.mark.parametrize("name,shape", MESH_CASES)
def test_mesh_gradients_match_single_process(runs, name, shape):
    got = runs["mesh"][(name, shape)]["grads"]
    want = runs["single"][name]["grads"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name,shape", MESH_CASES)
def test_mesh_train_step_matches_single_process(runs, name, shape):
    mesh = runs["mesh"][(name, shape)]
    single = runs["single"][name]
    for k, want in single["params_after"].items():
        np.testing.assert_allclose(mesh["params_after"][k], want, rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(mesh["metrics"][k], single["metrics"][k],
                                   rtol=1e-5)


def test_strategies_reached(runs):
    """tp 2 over 2 KV heads shards heads; tp 4 over 2 KV heads and 4 query
    heads duplicates the KV heads ("head" on the query heads); 6 heads
    over tp 4 take "seq" at 32 positions and "none" at 30."""
    assert runs["mesh"][("qwen3", (2, 2))]["strategies"] == ["head"]
    assert runs["mesh"][("qwen3", (1, 4))]["strategies"] == ["head"]
    assert runs["mesh"][("odd_heads", (1, 4))]["strategies"] == \
        ["none", "seq"]


def test_the_mesh_is_visible_to_other_threads():
    """On CUDA the autograd engine runs the backward (and a remat block's
    recomputation) on its own threads: they must see the forward's
    mesh."""
    import threading

    from repro_torch.distributed.sharding import (Mesh, current_mesh,
                                                  mesh_context)

    seen = []
    mesh = Mesh({"data": 1, "model": 2})
    with mesh_context(mesh):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [mesh]
    assert current_mesh() is None


def test_a_failed_step_under_a_mesh_ends_every_rank(tmp_path):
    """A step that fails on one rank is not retried there (a retry would
    pair its collectives with its peers' later ones): that rank raises,
    its peer's collective fails with it, and no rank finishes the run."""
    out = tmp_path / "done"
    procs = W.start(W.failing_train_worker, 2, tmp_path, str(out))
    for p in procs:
        p.join(timeout=150)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert alive == [False, False]
    assert all(p.exitcode != 0 for p in procs)
    assert not list(tmp_path.glob("done.*"))
