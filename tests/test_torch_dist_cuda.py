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
