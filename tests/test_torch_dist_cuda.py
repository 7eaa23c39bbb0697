"""The tensor-parallel paged serving steps on several cards: a (1, tp) NCCL
mesh, one rank a card, runs flash prefill on each rank's heads (or query
positions) and the fused paged decode on the gathered heads, through the
CUDA kernels.  Full-width configs cut to 2 layers, float backend, bf16
activations and pool.

Each rank also runs the unsharded steps on its card; the mesh run's decode
is fed the unsharded run's greedy tokens, so one step's rounding does not
change the next step's input.  Tolerance: every step's logits within 3e-2
of the largest unsharded logit (bf16: the row-parallel partial sums, the
vocabulary-parallel logits and the kernels' plans at the shard shapes add
in another order).

Also the ZeRO train step over NCCL (`test_zero_train_step_on_cards`).

Needs as many CUDA devices as the mesh has ranks; skips otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

pytestmark = pytest.mark.cuda

#: qwen3-4b: 32 query heads over 8 KV heads ("head" at tp 2 and 4);
#: qwen2-0.5b: 14 over 2 (tp 4 cuts a head: q gathered, the 8-token prefill
#: "seq", decode "none")
CASES = [("qwen3-4b", 2), ("qwen3-4b", 4), ("qwen2-0.5b", 4)]
N_LAYERS = 2
REL_ATOL = 3e-2


@pytest.mark.parametrize("arch,tp", CASES)
def test_tp_paged_steps_launch_the_kernels_on_cards(tmp_path, arch, tp):
    if not torch.cuda.is_available() or torch.cuda.device_count() < tp:
        pytest.skip(f"needs {tp} NVIDIA GPUs (one NCCL rank a card)")
    out = tmp_path / "res.pt"
    W.spawn(W.paged_cuda_worker, tp, tmp_path, str(out), arch, N_LAYERS,
            backend="nccl")
    res = torch.load(out, weights_only=False)
    assert res["calls"] == {"flash_prefill": N_LAYERS,
                            "paged_decode_attention": 3 * N_LAYERS}
    assert res["launches"]["flash_prefill"] == N_LAYERS
    assert res["launches"]["paged_decode_attention"] == 3 * N_LAYERS
    scale = max(np.abs(w).max() for w in res["want"])
    diffs = [float(np.abs(g - w).max())
             for g, w in zip(res["got"], res["want"])]
    print(f"{arch} tp {tp}: max |diff| by step {diffs}, largest logit "
          f"{scale}")
    for g, w in zip(res["got"], res["want"]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=REL_ATOL * scale)


#: the ZeRO train step's cards: full-width qwen2-0.5b cut to 2 layers,
#: float32, float backend, three steps of 8 x 33 seeded tokens
ZERO_CFG = dict(arch="qwen2-0.5b", n_layers=2)
ZERO_RT = dict(loss_chunk=0, compute_dtype="float32", quant_backend="float",
               remat="none")
ZERO_MESHES = [(2, 2), (4, 1)]


#: three AdamW steps of lr 1e-3 either way: the most an element's step can
#: move with the order of its gradient's sums
ZERO_STEP_ATOL = 2 * 3 * 1e-3


@pytest.mark.parametrize("shape", ZERO_MESHES)
def test_zero_train_step_on_cards(tmp_path, shape):
    """The ZeRO step (moments split over ``data``, gradients reduce-
    scattered over NCCL, updated shards all-gathered) against the same
    step with the moments at their parameters' placement, on four cards:
    the losses and norms within rtol 1e-6 and the moments within 1e-5 of
    each leaf's largest magnitude (tests/test_torch_dist_zero.py's), the
    parameters within ZERO_STEP_ATOL.  The parameters are not held to the
    CPU test's 1e-7 here: at full width an element whose ranks' gradients
    nearly cancel has a sum of the size of its rounding, which NCCL's
    reduce-scatter and all-reduce add in other orders, and AdamW divides
    each gradient by its own root mean square, so that element's step
    follows the order; and 1e-7 is less than one step of f32 at a norm
    gain near 1.  On four H100s at (4, 1): 153 of the tied embedding's
    136,134,656 elements up to 1.05e-5 apart (the same in two runs), one
    ``w_gate`` element 1.02e-7, seven norm gains 1.19e-7; at (2, 2) every
    element within 1e-7.  The elements past 1e-7 are printed."""
    from test_torch_dist_zero import NOISE_LEAVES, _atol

    world = shape[0] * shape[1]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA GPUs (one NCCL rank a card)")
    rng = np.random.default_rng(11)
    np.savez(tmp_path / "tokens.npz",
             **{str(i): rng.integers(0, 151936, (8, 33)).astype(np.int32)
                for i in range(3)})
    out = tmp_path / "zero.pt"
    W.spawn(W.zero_worker, world, tmp_path,
            [(str(out), shape, ZERO_CFG, None, str(tmp_path / "tokens.npz"),
              ZERO_RT)], 1e-3, "cuda", backend="nccl")
    res = torch.load(out, weights_only=False)
    got, want = res["zero"], res["params_placed"]
    print(f"zero {shape}: losses {[m['loss'] for m in got['metrics']]} / "
          f"{[m['loss'] for m in want['metrics']]}")
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    for k, w in want["params_after"].items():
        diff = np.abs(got["params_after"][k] - w)
        past = int((diff > _atol(k, 1e-7)).sum())
        if past:
            print(f"zero {shape}: {k}: {past} of {diff.size} elements past "
                  f"{_atol(k, 1e-7)}, the largest {diff.max():.3g}")
        assert diff.max() <= ZERO_STEP_ATOL, (k, float(diff.max()))
    for part in ("mu_after", "nu_after"):
        for k, w in want[part].items():
            if not k.endswith(NOISE_LEAVES):
                np.testing.assert_allclose(
                    got[part][k], w, rtol=0,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=f"{part} {k}")
    shapes = torch.load(f"{out}.rank0", weights_only=False)
    assert any(np.prod(s) < np.prod(shapes["params_placed"][k])
               for k, s in shapes["zero"].items())
