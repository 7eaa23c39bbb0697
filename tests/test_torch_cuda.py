"""The CUDA kernels against their plain versions, and the engine's main path
through them, on an NVIDIA GPU.  Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a GPU every test here skips.  Tolerances: the W4A4 kernel must
equal its plain version bit for bit (both divide with IEEE round-to-nearest
and round half to even); the attention kernels run a single-pass online
softmax against the plain versions' blocked sums and are held to atol 2e-2
in bf16, the bound the JAX package holds its Pallas kernels to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int4_matmul import (  # noqa: E402
    int4_matmul_fused_cuda, int4_matmul_fused_plain)
from repro_torch.kernels.packing import pack_kmajor  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    flash_prefill_cuda, flash_prefill_plain, paged_decode_attention_cuda,
    paged_decode_attention_plain)

ATOL = 2e-2
RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf(a, dev):
    return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 896, 128), (9, 71, 130),
                                   (256, 4864, 896), (33, 895, 4864)])
def test_int4_kernel_bit_exact(cuda, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen, device=cuda)
    x[:, 0] = x.abs().amax(dim=1)             # the row's amax ...
    x[:, 1] = x[:, 0] * 0.5                   # ... and a value 3.5 steps up
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device=cuda, dtype=torch.int8))
    w_scale = torch.rand((1, N), generator=gen, device=cuda) + 0.05
    assert torch.equal(int4_matmul_fused_cuda(x, w_km, w_scale),
                       int4_matmul_fused_plain(x, w_km, w_scale))


@pytest.mark.cuda
@pytest.mark.parametrize("ps,window", [(16, 0), (4, 0), (16, 21)])
def test_paged_decode_kernel_matches_plain(cuda, ps, window):
    B, H, KV, hd, pps = 5, 14, 2, 64, 8
    P = B * pps + 3
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    k = _bf(RNG.standard_normal((P, ps, KV, hd)).astype(np.float32), cuda)
    v = _bf(RNG.standard_normal((P, ps, KV, hd)).astype(np.float32), cuda)
    last = [pps * ps - 1, -1, pps * ps // 2, 0, ps]      # row 1 idle
    tbl = np.full((B, pps), P, np.int32)                 # sentinel slots
    pages = RNG.permutation(P).astype(np.int32)
    used = 0
    for b, lp in enumerate(last):
        n = (lp // ps + 1) if lp >= 0 else 0
        tbl[b, :n] = pages[used:used + n]
        used += n
    tbl_t = torch.from_numpy(tbl).to(cuda)
    lp_t = torch.tensor(last, dtype=torch.int32, device=cuda)
    got = paged_decode_attention_cuda(q, k, v, tbl_t, lp_t, window=window)
    want = paged_decode_attention_plain(q, k, v, tbl_t, lp_t, window=window)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert not got[1].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
def test_flash_kernel_matches_plain(cuda, window):
    B, S, H, KV, hd = 2, 70, 14, 2, 64
    q = _bf(RNG.standard_normal((B, S, H, hd)).astype(np.float32), cuda)
    k = _bf(RNG.standard_normal((B, S, KV, hd)).astype(np.float32), cuda)
    v = _bf(RNG.standard_normal((B, S, KV, hd)).astype(np.float32), cuda)
    pos = np.arange(S, dtype=np.int32)[None] - np.array([[0], [6]], np.int32)
    pos = torch.from_numpy(np.where(pos >= 0, pos, -1).astype(np.int32)).to(
        cuda)
    got = flash_prefill_cuda(q, k, v, pos, pos, window=window)
    want = flash_prefill_plain(q, k, v, pos, pos, window=window)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert not got[1, :6].float().any()                  # left padding


@pytest.mark.cuda
def test_engine_main_path_launches_every_kernel(cuda):
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    # head dim 64 as at full width (the only one the attention kernels take)
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="bfloat16")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64)
    engine = InferenceEngine(cfg, rt, sv, device=cuda)
    ops.reset_launch_counts()
    _, fin = run_trace(engine, poisson_trace(6, 1.0, (8, 20), (4, 8),
                                             cfg.vocab, seed=1))
    assert all(r.outcome == "ok" and len(r.tokens) == r.max_new for r in fin)
    assert all(0 <= t < cfg.vocab for r in fin for t in r.tokens)
    assert all(n > 0 for n in ops.launch_counts().values())
