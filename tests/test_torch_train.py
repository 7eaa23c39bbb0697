"""Port parity for training (``repro_torch.data``, ``optim``,
``models.transformer.lm_loss``, ``launch.steps.make_train_step``,
``launch.train``) against the JAX package on the CPU.

Tolerances, with their reasons:

  * the synthetic batches are pure numpy in both packages: equal exactly;
  * `warmup_cosine` is a few float32 scalar ops: within 1 ulp (rtol 1e-6);
  * AdamW over three steps on the same gradients: the global norm sums
    leaves in another order, so the clip scale and everything after it can
    differ by float32 rounding: each leaf within 1e-6 of its norm;
  * `lm_loss` in float32 activations: the port's chunked loss sums chunks
    in a Python loop where the JAX package scans, and the reductions round
    in another order: the loss within relative 1e-5, each gradient leaf
    within 1e-4 of the leaf's norm (observed ~1e-6);
  * three train steps from the same state: the metrics within relative
    1e-5, the updated parameters within 1e-5 of each leaf's norm, but for
    the attention's key bias: softmax over the keys is blind to a shift
    every key's score shares, so its exact gradient is zero and both
    packages' are float32 rounding noise (~1e-9), which Adam's
    normalization turns into steps of up to the rate in either direction:
    it is held to move at most the summed rates;
  * remat and the loss's chunking change no number: equal exactly;
  * a preempted `train()` resumes from its checkpoint to the state an
    uninterrupted run reaches: equal exactly (the CPU is deterministic).
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.optim as joptim  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro_torch.convert import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.models.transformer import lm_loss  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

ARCH = "qwen2-0.5b"
#: float32 activations, exact attention, the JAX trainer's runtime
JRT_KW = dict(attn_impl="chunked", attn_chunk_q=16, loss_chunk=0,
              remat="none", compute_dtype="float32")
RT_KW = dict(attn_impl="chunked", attn_chunk_q=16, loss_chunk=0,
             remat="none", compute_dtype="float32")
B, S = 2, 16
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _cfgs(arch, layers=None):
    over = {"n_layers": layers} if layers else {}
    return (jconfigs.get_config(arch).reduced(**over),
            tconfigs.get_config(arch).reduced(**over))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().to(torch.float32).numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _assert_leaves_close(want, got, rel, what):
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg), what
    for k in fw:
        err = np.linalg.norm(fw[k] - fg[k])
        assert err <= rel * max(np.linalg.norm(fw[k]), 1e-30), (what, k, err)


def _batch(vocab, step=0, seq=S, batch=B):
    return tdata.SyntheticLMDataset(vocab=vocab, seq_len=seq,
                                    global_batch=batch).batch(step)


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("shard_count,seed", [(1, 0), (2, 3)])
def test_synthetic_batches_equal_the_jax_package(shard_count, seed):
    for shard in range(shard_count):
        kw = dict(vocab=300, seq_len=24, global_batch=4, seed=seed,
                  shard_index=shard, shard_count=shard_count)
        j, t = jdata.SyntheticLMDataset(**kw), tdata.SyntheticLMDataset(**kw)
        for step in (0, 1, 7):
            np.testing.assert_array_equal(t.batch(step), j.batch(step))
    # resumed iterators pick up the stream where it stopped
    ds = tdata.SyntheticLMDataset(vocab=300, seq_len=24, global_batch=4,
                                  seed=seed)
    it = tdata.make_batch_iterator(ds, start_step=5)
    jt_ = jdata.make_batch_iterator(jdata.SyntheticLMDataset(
        vocab=300, seq_len=24, global_batch=4, seed=seed), start_step=5)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(it), next(jt_))
    finally:
        it.close()
        jt_.close()


# ----------------------------------------------------------------- optim ----
def test_warmup_cosine_equals_the_jax_package():
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(joptim.warmup_cosine(s, **kw))
        got = toptim.warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_adamw_and_clip_over_three_steps_equal_the_jax_package():
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"b": {"w": rng.standard_normal((16, 8)).astype(np.float32)
                      * scale,
                      "v": rng.standard_normal(8).astype(np.float32) * scale},
                "a": rng.standard_normal((5, 3)).astype(np.float32) * scale}

    params = tree(1.0)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params, "cpu")
    jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for step, gscale in enumerate((0.3, 2.0, 0.05)):   # clipped at step 2
        g = tree(gscale)
        jg, tg = jax.tree.map(jnp.asarray, g), params_from_jax(g, "cpu")
        jclip, jgn = joptim.clip_by_global_norm(jg, 1.0)
        tclip, tgn = toptim.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        _assert_leaves_close(jclip, tclip, 1e-6, "clip")
        lr = 1e-2 * (step + 1)
        jp, jst, jinfo = joptim.adamw_update(jp, jg, jst,
                                             jnp.asarray(lr, jnp.float32))
        tp, tst, tinfo = toptim.adamw_update(
            tp, tg, tst, torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        assert tst["step"].dtype == torch.int32
        for name, a, b in (("params", jp, tp), ("mu", jst["mu"], tst["mu"]),
                           ("nu", jst["nu"], tst["nu"])):
            _assert_leaves_close(a, b, 1e-6, name)


# ------------------------------------------------------------------ loss ----
def _loss_and_grads_both(arch, quant, layers=None):
    jcfg, cfg = _cfgs(arch, layers)
    jrt = jconfigs.Runtime(quant_backend=quant, **JRT_KW)
    rt = tconfigs.Runtime(quant_backend=quant, **RT_KW)
    jp = j_init_model(jax.random.PRNGKey(0), jcfg)
    tokens = _batch(jcfg.vocab)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_lm_loss(p, jnp.asarray(tokens), jcfg, jrt),
        has_aux=True)(jp)
    live = tree_map(lambda p: p.requires_grad_(True),
                    params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    tl, tm = lm_loss(live, torch.from_numpy(tokens), cfg, rt)
    grads = torch.autograd.grad(tl, tree_leaves(live), allow_unused=True)
    keys = sorted(_flat(jg))
    tg = {k: (g if g is not None else torch.zeros(1))
          for k, g in zip(keys, grads)}
    return (jl, jm, jg), (tl.detach(),
                          {k: v.detach() for k, v in tm.items()}, tg)


@pytest.mark.parametrize("arch,quant,layers", [
    (ARCH, "float", 2), (ARCH, "fake_quant", 2), (ARCH, "int_sim", 2),
    ("arctic-480b", "fake_quant", None)])
def test_lm_loss_and_gradients_match_the_jax_package(arch, quant, layers):
    """Reduced qwen2-0.5b in float, under the QAT straight-through
    estimator and under int_sim (the JAX trainer trains through int_sim:
    its gradient reaches the weights and activations through their
    scales), and an MoE config, whose loss carries the router's aux."""
    (jl, jm, jg), (tl, tm, tg) = _loss_and_grads_both(arch, quant, layers)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if arch != ARCH:
        assert float(tm["aux"]) > 0
        _, cfg = _cfgs(arch)
        np.testing.assert_allclose(
            float(tl), float(tm["nll"]) + cfg.router_aux_coef
            * float(tm["aux"]), rtol=1e-6)
    fj = _flat(jg)
    for k, g in tg.items():
        g = g.numpy() if g.numel() > 1 else np.zeros_like(fj[k])
        err = np.linalg.norm(g - fj[k])
        assert err <= GRAD_RTOL * max(np.linalg.norm(fj[k]), 1e-30), (k, err)
    assert np.linalg.norm(tg["layers/u0/attn/wq"].numpy()) > 0


def _loss_grads(cfg, rt, params, tokens):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    loss, _ = lm_loss(live, tokens, cfg, rt)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live),
                                              allow_unused=True)


def test_chunked_loss_and_remat_change_no_number():
    _, cfg = _cfgs(ARCH, 2)
    gen = torch.Generator().manual_seed(0)
    params = init_train_state(gen, cfg)["params"]
    tokens = torch.from_numpy(_batch(cfg.vocab))
    base = tconfigs.Runtime(**RT_KW)
    want_l, want_g = _loss_grads(cfg, base, params, tokens)
    import dataclasses

    for over in ({"loss_chunk": 8}, {"loss_chunk": 16}, {"remat": "dots"},
                 {"remat": "full"}, {"remat": "dots", "loss_chunk": 8}):
        rt = dataclasses.replace(base, **over)
        got_l, got_g = _loss_grads(cfg, rt, params, tokens)
        if "loss_chunk" in over:
            # chunked sums round in another order than one sum
            np.testing.assert_allclose(float(got_l), float(want_l),
                                       rtol=1e-6)
        else:
            assert torch.equal(got_l, want_l), over
            for a, b in zip(got_g, want_g):
                assert (a is None and b is None) or torch.equal(a, b), over
    with pytest.raises(ValueError, match="remat"):
        _loss_grads(cfg, dataclasses.replace(base, remat="some"), params,
                    tokens)


# ------------------------------------------------------------ train step ----
def test_three_train_steps_match_the_jax_package():
    jcfg, cfg = _cfgs(ARCH, 2)
    jrt = jconfigs.Runtime(quant_backend="fake_quant", **JRT_KW)
    rt = tconfigs.Runtime(quant_backend="fake_quant", **RT_KW)
    kw = dict(peak_lr=3e-3, warmup=2, total_steps=3)
    jstate = j_init_train_state(jax.random.PRNGKey(1), jcfg)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(jcfg, jrt, **kw))
    step = make_train_step(cfg, rt, **kw)
    for i in range(3):
        tokens = _batch(jcfg.vocab, step=i)
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(tokens))
        for k in ("loss", "nll", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-8,
                                       err_msg=f"step {i} {k}")
    assert int(state["step"]) == int(state["opt"]["step"]) == 3
    fw, fg = _flat(jstate["params"]), _flat(state["params"])
    noise = [k for k in fw if k.endswith("wk_bias")]
    lr_sum = sum(float(joptim.warmup_cosine(
        i, peak_lr=kw["peak_lr"], warmup_steps=kw["warmup"],
        total_steps=kw["total_steps"])) for i in range(3))
    for k in noise:
        assert np.abs(fw[k] - fg[k]).max() <= 2 * lr_sum, k
    _assert_leaves_close({k: v for k, v in fw.items() if k not in noise},
                         {k: v for k, v in fg.items() if k not in noise},
                         1e-5, "params")
    _assert_leaves_close(jstate["opt"]["mu"], state["opt"]["mu"], 1e-4, "mu")
    # the step moved the weights
    moved = _flat(state["params"])["layers/u0/ffn/w_in"]
    first = _flat(train_state_from_jax(jax.tree.map(
        np.asarray, j_init_train_state(jax.random.PRNGKey(1), jcfg)),
        "cpu")["params"])["layers/u0/ffn/w_in"]
    assert not np.array_equal(moved, first)


@pytest.mark.parametrize("arch", sorted(tconfigs.REGISTRY))
def test_reduced_train_step_finite(arch):
    """After the JAX package's per-config smoke step: every config's
    reduced train step (its own quant backend, bf16 activations, the
    default remat) gives a finite loss, finite gradients (grad norm) and
    finite new parameters."""
    cfg = tconfigs.get_config(arch).reduced()
    rt = tconfigs.Runtime(attn_impl="chunked", attn_chunk_q=8, loss_chunk=0)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(cfg, rt, peak_lr=1e-3, warmup=1, total_steps=2)
    tokens = torch.from_numpy(_batch(cfg.vocab, seq=16))
    for _ in range(2):
        state, m = step(state, tokens)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert float(m["grad_norm"]) > 0
    for leaf in tree_leaves(state["params"]):
        assert torch.isfinite(leaf).all()


# ----------------------------------------------------------------- train ----
def test_preempted_train_equals_the_uninterrupted_run(tmp_path):
    """After the JAX package's preemption test: 6 steps straight, against 3
    steps and a new `train()` that resumes from the step-3 checkpoint;
    the final parameters, moments and steps equal bit for bit."""
    from repro_torch.launch.train import train

    kw = dict(batch=2, seq=16, save_every=3, seed=7, device="cpu",
              quant_backend="fake_quant")
    s1, h1 = train(ARCH, steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    _, h2a = train(ARCH, steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    s2, h2b = train(ARCH, steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(h1) == 6 and len(h2a) == 3 and len(h2b) == 3
    assert h1 == h2a + h2b
    f1, f2 = _flat(s1), _flat(s2)
    assert sorted(f1) == sorted(f2)
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k], err_msg=k)
    assert int(s2["step"]) == 6
    # a run that finds its last step on disk has nothing left to do
    _, h3 = train(ARCH, steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert h3 == []


def test_train_refuses_a_mesh_a_missing_gpu_and_kernel_only_backends(
        monkeypatch):
    from repro_torch.launch.train import train

    _, cfg = _cfgs(ARCH, 2)
    for quant in ("lut4", "w4a16", "w4a4_packed", "netlist"):
        with pytest.raises(NotImplementedError, match="no backward"):
            make_train_step(cfg, tconfigs.Runtime(quant_backend=quant))

    # a mesh larger than the running processes (none here) is refused
    # before any process group starts
    with pytest.raises(ValueError, match="mesh needs 8 ranks"):
        train(ARCH, steps=1, mesh_spec="2,4", device="cpu", ckpt_dir=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(ARCH, steps=1, ckpt_dir=None)
    # a cuda mesh without a GPU: no fallback to gloo or the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(ARCH, steps=1, mesh_spec="1,1", ckpt_dir=None)


def test_cli_prints_the_losses_last(tmp_path, capsys):
    from repro_torch.launch import train as train_mod

    train_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt", str(tmp_path), "--quant", "int_sim"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"first_loss", "last_loss", "steps"}
    assert last["steps"] == 3 and np.isfinite(last["last_loss"])
    # run again on the finished directory: nothing left to train
    train_mod.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"first_loss": None, "last_loss": None, "steps": 0}


# -------------------------------------------------------------- examples ----
def test_example_twins_run_on_the_cpu(tmp_path, capsys):
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "examples"

    def load(name):
        spec = importlib.util.spec_from_file_location(name,
                                                      root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    history = load("train_qat_lm_torch").main(
        ["--device", "cpu", "--reduced", "--steps", "12", "--lr", "3e-2",
         "--ckpt", str(tmp_path)])
    assert history[-1] < history[0]
    out = load("serve_quantized_torch").main(["--device", "cpu",
                                              "--requests", "2"])
    assert out["quantized_ckpt"]["bit_identical_logits"]
    assert "from quantized ckpt" in capsys.readouterr().out
