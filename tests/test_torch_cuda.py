"""The CUDA kernels against their plain versions, and the engine's main path
through them, on an NVIDIA GPU.  Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a GPU every test here skips.  Tolerances: the W4A4 kernels (fused
and unfused) and the table-lookup kernel must equal their plain versions
bit for bit (integer dots; the fused one divides with IEEE round-to-nearest
and rounds half to even), and the table-lookup kernel the unfused W4A4
kernel; the elementwise table product is exact; the W4A16 kernel is held
to chip_smoke.W4A16_RTOL of the output's largest magnitude (f32 sums in
another order than its plain version's) and, having no atomics, gives the
same bits call after call; the attention kernels run a
single-pass online softmax against the plain versions' blocked sums and
are held to atol 2e-2 in bf16, the bound the JAX package holds its Pallas
kernels to, on bf16,
int8 and int4 pools alike (both dequantize as bf16(q * scale)); flash
prefill, whose sums have no atomics, also gives the same bits call after
call, at every group size, head dim and tail shape of FLASH_SHAPES, and so
does paged decode, whose splits merge in rank order.  The ragged kernel
shares the paged decode kernel's body and split, so a decode-only pack
must give the paged decode kernel's output bit for bit.  Every kernel
wrapper captured in a CUDA graph must replay to its eager call's bits, and
the engine with captured steps must emit an eager engine's tokens and
kernel launch counts.
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
from repro_torch.kernels.ragged_attention import (  # noqa: E402
    ragged_decode_attention_cuda, ragged_decode_attention_plain)
from repro_torch.models.attention import quantize_kv  # noqa: E402

ATOL = 2e-2
RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf(a, dev):
    return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)


def _pools(shape, cache_dtype, dev):
    """K and V pools (with scales, or None) of seeded normal values:
    bf16, or quantized per (token, head) as the serving writes do."""
    out = []
    for _ in range(2):
        vals = torch.from_numpy(
            RNG.standard_normal(shape).astype(np.float32)).to(dev)
        if cache_dtype == "bfloat16":
            out.append((vals.to(torch.bfloat16), None))
        else:
            out.append(quantize_kv(vals, int4=cache_dtype == "int4"))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _table(B, pps, P, ps, last):
    tbl = np.full((B, pps), P, np.int32)                 # sentinel slots
    pages = RNG.permutation(P).astype(np.int32)
    used = 0
    for b, lp in enumerate(last):
        n = (lp // ps + 1) if lp >= 0 else 0
        tbl[b, :n] = pages[used:used + n]
        used += n
    return tbl


#: the W4A4 tensor-core kernel's rows: decode, the 16 / 17 tile boundary,
#: the prefill buckets, the ragged budget
W4A4_M = [1, 8, 16, 17, 32, 64, 128, 256]
#: qwen2-0.5b's projections (K, N)
W4A4_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
#: beside them: odd K and N % 16 != 0 (1-byte loads), a split plan of odd
#: rows, and the widest plan (64 x 128 tiles, one split)
W4A4_ODD = [(9, 71, 130), (33, 895, 4864), (2, 301, 40), (70, 1001, 72),
            (5, 2048, 96), (256, 896, 4864)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(m, k, n) for m in W4A4_M
                                   for k, n in W4A4_KN] + W4A4_ODD)
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
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
@pytest.mark.parametrize("ps,window", [(16, 0), (4, 0), (16, 21)])
def test_paged_decode_kernel_quantized_pools(cuda, cache_dtype, ps, window):
    B, H, KV, hd, pps = 5, 14, 2, 64, 8
    P = B * pps + 3
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    last = [pps * ps - 1, -1, pps * ps // 2, 0, ps]      # row 1 idle
    tbl = torch.from_numpy(_table(B, pps, P, ps, last)).to(cuda)
    lp = torch.tensor(last, dtype=torch.int32, device=cuda)
    got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                      window=window)
    want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs,
                                        window=window)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert not got[1].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("G", [2, 7])
def test_ragged_kernel_matches_plain(cuda, ps, cache_dtype, G):
    """The reference's ragged kernel test geometry (two live table rows, a
    dead all-sentinel row, interior padding rows) at head dim 64."""
    P, KV, hd, pps, maxB = 8, 2, 64, 3, 3
    H = KV * G
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    tbl = np.full((maxB, pps), P, np.int32)
    tbl[:2] = RNG.permutation(P)[:2 * pps].reshape(2, pps)
    max_pos = pps * ps - 1
    slot = torch.tensor([0, 1, -1, 0, 1, -1, 2], dtype=torch.int32,
                        device=cuda)
    pos = torch.tensor([0, max_pos, -1, max_pos // 2, max_pos // 3, 3, -1],
                       dtype=torch.int32, device=cuda)
    q = _bf(RNG.standard_normal((7, H, hd)).astype(np.float32), cuda)
    tbl_t = torch.from_numpy(tbl).to(cuda)
    for window in (0, 5):
        got = ragged_decode_attention_cuda(q, k, v, tbl_t, slot, pos, ks, vs,
                                           window=window)
        want = ragged_decode_attention_plain(q, k, v, tbl_t, slot, pos, ks,
                                             vs, window=window)
        assert (got.float() - want.float()).abs().max().item() <= ATOL
        assert not got[(slot < 0) | (pos < 0)].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("ps", [1, 4, 16])
def test_ragged_decode_only_pack_equals_paged_decode(cuda, cache_dtype, ps):
    """One row per slot, each at its last position: the ragged kernel's
    output is the paged decode kernel's, bit for bit (both split a table
    of 128 tokens alike: 2 splits of 64)."""
    B, H, KV, hd = 6, 14, 2, 64
    pps = 128 // ps
    P = B * pps
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    last = [127, -1, 64, 0, 15, 100]
    tbl = torch.from_numpy(_table(B, pps, P, ps, last)).to(cuda)
    lp = torch.tensor(last, dtype=torch.int32, device=cuda)
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    slots = torch.arange(B, dtype=torch.int32, device=cuda)
    dec = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs)
    rag = ragged_decode_attention_cuda(q, k, v, tbl, slots, lp, ks, vs)
    assert torch.equal(dec, rag)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("pps,ps,last,window", [
    # 512-token table, 8 splits of 64: last positions on split edges, a
    # window of 21 inside one split and one of 100 across three
    (32, 16, [63, 64, 511, -1, 127, 128, 0], 0),
    (32, 16, [63, 64, 511, -1, 127, 128, 0], 21),
    (32, 16, [63, 64, 511, -1, 127, 128, 0], 100),
    # a 2,048-token table: splits of 256 tokens, four rounds of 64 each
    (128, 16, [2047, 255, 256, 1000, -1], 0),
    (128, 16, [2047, 255, 256, 1000, -1], 300),
    # pages of 12 tokens: splits of 72, a round of 64 and one of 8
    (8, 12, [95, 71, 72, 5], 0)])
def test_paged_decode_split_edges_and_two_calls(cuda, cache_dtype, pps, ps,
                                                last, window):
    """The split kernel against the plain version where rows end on split
    edges, windows cross splits and splits take several rounds; idle rows
    exactly zero, and two calls bit-equal (splits merge in rank order)."""
    B, H, KV, hd = len(last), 14, 2, 64
    P = B * pps + 3
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    tbl = torch.from_numpy(_table(B, pps, P, ps, last)).to(cuda)
    lp = torch.tensor(last, dtype=torch.int32, device=cuda)
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs, window=window)
    again = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                        window=window)
    want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs,
                                        window=window)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert torch.equal(got, again)
    idle = [b for b, x in enumerate(last) if x < 0]
    assert not got[idle].float().any()


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


def _flash_positions(B, Sq, Skv, pads, hit):
    """Query positions (row b left-padded by pads[b], its first real query
    at `hit`) and key positions: the same vector for a fresh prefill
    (Skv == Sq, no hit), else cache slots live up to the row's last query."""
    base = np.arange(Sq, dtype=np.int32)[None] \
        - np.asarray(pads, np.int32)[:, None]
    qpos = np.where(base >= 0, base + hit, -1).astype(np.int32)
    if Skv == Sq and not hit:
        return qpos, qpos
    j = np.arange(Skv, dtype=np.int32)[None]
    last = hit + Sq - np.asarray(pads, np.int32)[:, None] - 1
    return qpos, np.where(j <= last, j, -1).astype(np.int32)


#: (B, Sq, Skv, H, KV, hd, left paddings, prefix hit, window): G = 1, 2, 7
#: and 8, hd 64 and 128, one query, 17 and 70 queries over a longer cache
#: (a prefix hit), the 256 bucket fresh and over a 512-slot cache, rows of a
#: batch padded differently; hd 256 at G = 16 over one KV head
#: (recurrentgemma-9b's attention: Q fragments read from shared memory at
#: each k-step), with the window off and on, fresh and over a cache
FLASH_SHAPES = {
    "g1": (2, 70, 70, 4, 4, 64, (0, 6), 0, 0),
    "g2_window": (2, 70, 70, 4, 2, 64, (0, 6), 0, 24),
    "g7_hd128": (2, 70, 70, 14, 2, 128, (3, 11), 0, 0),
    "g8_window": (2, 70, 70, 16, 2, 64, (0, 9), 0, 24),
    "sq1_tail": (2, 1, 96, 14, 2, 64, (0, 0), 40, 0),
    "sq17_tail": (2, 17, 100, 14, 2, 64, (0, 5), 30, 0),
    "sq70_tail_hd128_window": (2, 70, 200, 14, 2, 128, (2, 8), 64, 24),
    "sq256": (1, 256, 256, 14, 2, 64, (56,), 0, 0),
    "sq256_tail": (2, 256, 512, 14, 2, 64, (0, 40), 100, 0),
    "g16_hd256": (2, 70, 70, 16, 1, 256, (0, 9), 0, 0),
    "g16_hd256_window": (1, 256, 256, 16, 1, 256, (56,), 0, 48),
    "g16_hd256_tail_window": (2, 64, 512, 16, 1, 256, (0, 14), 160, 48),
    "g16_hd256_tail": (1, 17, 300, 16, 1, 256, (3,), 120, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernel_shapes(cuda, shape):
    """The tensor-core kernel against its plain version over the plan's row
    and K/V tiles: within ATOL, padding rows exactly zero, two calls
    bit-equal (no atomics in the sums)."""
    B, Sq, Skv, H, KV, hd, pads, hit, window = FLASH_SHAPES[shape]
    q = _bf(RNG.standard_normal((B, Sq, H, hd)).astype(np.float32), cuda)
    k = _bf(RNG.standard_normal((B, Skv, KV, hd)).astype(np.float32), cuda)
    v = _bf(RNG.standard_normal((B, Skv, KV, hd)).astype(np.float32), cuda)
    qpos, kpos = (torch.from_numpy(p).to(cuda)
                  for p in _flash_positions(B, Sq, Skv, pads, hit))
    got = flash_prefill_cuda(q, k, v, qpos, kpos, window=window)
    again = flash_prefill_cuda(q, k, v, qpos, kpos, window=window)
    want = flash_prefill_plain(q, k, v, qpos, kpos, window=window)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert torch.equal(got, again)
    for b, pad in enumerate(pads):
        assert not got[b, :pad].float().any()            # left padding


@pytest.mark.cuda
def test_flash_kernel_refuses_unbuilt_head_dim(cuda):
    q = torch.zeros((1, 8, 4, 32), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(ValueError):
        flash_prefill_cuda(q, k, k, pos, pos)


#: the decode kernels' shapes beside qwen2-0.5b's (H, KV, hd): qwen3-4b,
#: qwen2-vl-2b, internlm2-20b, starcoder2-7b (G = 9 at hd 128),
#: musicgen-large (G = 1 at hd 64), arctic-480b (G = 7), llama4-maverick
#: (G = 5)
DECODE_NEW_SHAPES = [(32, 8, 128), (12, 2, 128), (48, 8, 128), (36, 4, 128),
                     (32, 32, 64), (56, 8, 128), (40, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("shape", DECODE_NEW_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_kernels_at_the_new_shapes(cuda, cache_dtype, shape):
    """Paged decode and the ragged kernel at head dim 128 with G = 4, 5, 6, 7,
    9 and at head dim 64 with G = 1, on a 512-token table (8 splits), with
    and without a window: within ATOL of the plain versions, idle and
    padding rows exactly zero, two calls bit-equal, and a decode-only
    ragged pack bit-equal to paged decode."""
    H, KV, hd = shape
    ps, pps = 16, 32
    last = [511, 63, -1, 64, 300, 0]
    B = len(last)
    P = B * pps + 3
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    tbl = torch.from_numpy(_table(B, pps, P, ps, last)).to(cuda)
    lp = torch.tensor(last, dtype=torch.int32, device=cuda)
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    slots = torch.arange(B, dtype=torch.int32, device=cuda)
    # a pack: decode rows, a 3-row chunk of row 4's request, padding
    slot2 = torch.tensor([0, 4, 4, 4, -1, 1], dtype=torch.int32, device=cuda)
    pos2 = torch.tensor([511, 280, 290, 300, -1, 63], dtype=torch.int32,
                        device=cuda)
    for window in (0, 40):
        got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                          window=window)
        want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs,
                                            window=window)
        assert (got.float() - want.float()).abs().max().item() <= ATOL
        assert torch.equal(got, paged_decode_attention_cuda(
            q, k, v, tbl, lp, ks, vs, window=window))
        assert not got[2].float().any()
        assert torch.equal(got, ragged_decode_attention_cuda(
            q, k, v, tbl, slots, lp, ks, vs, window=window))
        rag = ragged_decode_attention_cuda(q, k, v, tbl, slot2, pos2, ks, vs,
                                           window=window)
        want = ragged_decode_attention_plain(q, k, v, tbl, slot2, pos2, ks,
                                             vs, window=window)
        assert (rag.float() - want.float()).abs().max().item() <= ATOL
        assert not rag[4].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 2, 96), (34, 2, 128), (18, 2, 64),
                                   (8, 8, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_kernels_refuse_an_unbuilt_shape(cuda, shape):
    """A CUDA tensor at a shape the kernels are not built for raises: no
    quiet switch to the plain version."""
    H, KV, hd = shape
    q = torch.zeros((2, H, hd), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((4, 16, KV, hd), dtype=torch.bfloat16, device=cuda)
    tbl = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    lp = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is not built"):
        ops.paged_decode_attention(q, pool, pool, tbl, lp)
    with pytest.raises(ValueError, match="is not built"):
        ops.ragged_paged_attention(q, pool, pool, tbl, lp, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["bucketed", "ragged"])
def test_engine_qwen3_reduced_at_head_dim_128(cuda, step):
    """The reduced qwen3-4b (qk_norm) at head dim 128 and its full width's
    32 heads over 8 (2 layers) serves on the card through the W4A4 GEMM
    and, bucketed, flash prefill and paged decode once a layer a forward,
    or, ragged, the ragged kernel once a layer a step."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.api import mixed_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-4b").reduced(n_layers=2, head_dim=128,
                                         n_heads=32, n_kv_heads=8)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="bfloat16" if step == "bucketed" else "int8")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64,
                       step=step)
    engine = InferenceEngine(cfg, rt, sv, device=cuda)
    ops.reset_launch_counts()
    _, fin = run_trace(engine, mixed_trace(6, (8, 20, 33), (4, 8),
                                           cfg.vocab, seed=2))
    assert len(fin) == 6
    assert all(r.outcome == "ok" and len(r.tokens) == r.max_new for r in fin)
    assert all(0 <= t < cfg.vocab for r in fin for t in r.tokens)
    n = ops.launch_counts()
    forwards = n["int4_matmul_fused"] // (7 * 2)
    assert n["int4_matmul_fused"] == 7 * 2 * forwards > 0, n
    if step == "bucketed":
        assert n["flash_prefill"] > 0 and n["paged_decode_attention"] > 0, n
        assert n["flash_prefill"] + n["paged_decode_attention"] \
            == 2 * forwards, n
        assert n["ragged_decode_attention"] == 0, n
    else:
        assert n["ragged_decode_attention"] == 2 * forwards, n
        assert n["flash_prefill"] == n["paged_decode_attention"] == 0, n


@pytest.mark.cuda
def test_engine_main_path_launches_every_kernel(cuda):
    """The bucketed path launches its three kernels (GEMM, flash prefill,
    paged decode) and never the ragged one."""
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
    n = ops.launch_counts()
    assert all(n[k] > 0 for k in ("int4_matmul_fused", "flash_prefill",
                                  "paged_decode_attention")), n
    assert n["ragged_decode_attention"] == 0, n


@pytest.mark.cuda
def test_engine_ragged_int4_path(cuda):
    """A 2-layer, head-dim-64 ragged engine on an int4 pool: every request
    retires ok, through the GEMM and the ragged kernel alone."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.api import mixed_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="int4")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64,
                       step="ragged")
    engine = InferenceEngine(cfg, rt, sv, device=cuda)
    ops.reset_launch_counts()
    _, fin = run_trace(engine, mixed_trace(6, (8, 20, 33), (4, 8),
                                           cfg.vocab, seed=1))
    assert len(fin) == 6
    assert all(r.outcome == "ok" and len(r.tokens) == r.max_new for r in fin)
    assert all(0 <= t < cfg.vocab for r in fin for t in r.tokens)
    n = ops.launch_counts()
    assert n["int4_matmul_fused"] > 0 and n["ragged_decode_attention"] > 0, n
    assert n["flash_prefill"] == 0 and n["paged_decode_attention"] == 0, n


def _chip_smoke():
    """chip_smoke.py at the repository root, imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["scale x2", "bytes negated"])
def test_ragged_int8_card_vs_cpu_catches_a_planted_fault(cuda, monkeypatch,
                                                         fault):
    """chip_smoke.py's int8-pool card-vs-CPU run (2 layers at full width,
    the ragged step) holds the card within CPU_ATOL of the CPU, and the
    same run fails that limit once the card's quantizing K/V writes are
    broken: every scale doubled, or every byte negated."""
    from repro_torch.configs import Runtime
    from repro_torch.serving import kv_pages

    cs = _chip_smoke()
    rt = Runtime(quant_backend="float", cache_dtype="int8")
    sound, _ = cs._two_devices_ragged(torch, rt)
    err = (sound["cuda"] - sound["cpu"]).abs().max().item()

    quantize = kv_pages.quantize_kv

    def broken(val, int4):
        q, scale = quantize(val, int4)
        if not val.is_cuda:
            return q, scale
        return (q, scale * 2) if fault == "scale x2" else (-q, scale)

    monkeypatch.setattr(kv_pages, "quantize_kv", broken)
    planted, launches = cs._two_devices_ragged(torch, rt)
    err_planted = (planted["cuda"] - planted["cpu"]).abs().max().item()
    print(f"int8 ragged card vs CPU: max |logit diff| sound {err:.6g}, "
          f"{fault} {err_planted:.6g} (limit {cs.CPU_ATOL})")
    assert launches["ragged_decode_attention"] > 0, launches
    assert err <= cs.CPU_ATOL < err_planted


# ------------------------------------------------ the third slice's GEMMs --
#: (K, N) of qwen2-0.5b's projections and the serving paths' rows
MAIN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
MAIN_M = [1, 8, 64, 256]


def _w4a16_check(cuda, M, K, N, G):
    from repro_torch.core.quant import group_quantize, pack_int4
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
    from repro_torch.kernels.w4a16_matmul import (w4a16_matmul_cuda,
                                                  w4a16_matmul_plain)

    gen = torch.Generator(device=cuda).manual_seed(M * 7 + K + N + G)
    w = torch.randn((K, N), generator=gen, device=cuda) * 0.02
    w_q, w_scale = group_quantize(w, G)
    w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
    x32 = torch.randn((M, K), generator=gen, device=cuda)
    for dt in (torch.bfloat16, torch.float32):
        x = x32.to(dt)
        got = w4a16_matmul_cuda(x, w_km, w_scale, G)
        want = w4a16_matmul_plain(x, w_km, w_scale, G)
        err = (got - want).abs().max().item()
        assert err <= _chip_smoke().W4A16_RTOL * want.abs().max().item(), \
            (dt, err)


@pytest.mark.cuda
@pytest.mark.parametrize("M", MAIN_M)
@pytest.mark.parametrize("K,N", MAIN_KN)
def test_w4a16_kernel_matches_plain(cuda, M, K, N):
    """Per channel and grouped (G = 128: at K = 896 the repack pads K to
    1024 and the high plane carries a group of zeros), bf16 and f32 x."""
    for G in (K, 128):
        _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,G", [(9, 130, 50, 130), (1, 77, 24, 77),
                                     (16, 192, 32, 64), (100, 512, 130, 128),
                                     (33, 96, 40, 32)])
def test_w4a16_kernel_odd_shapes(cuda, M, K, N, G):
    _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("M", range(1, 17))
@pytest.mark.parametrize("K,N", [(4864, 896), (896, 128)])
def test_w4a16_splitk_every_decode_row_count(cuda, M, K, N):
    """The split-K path at every M it takes, on the largest and the
    smallest projection: per channel and grouped, bf16 and f32 x."""
    for G in (K, 128):
        _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,G", [(8, 256, 50, 64), (16, 896, 130, 128),
                                     (3, 512, 24, 128), (5, 77, 6, 77)])
def test_w4a16_splitk_one_byte_loads(cuda, M, K, N, G):
    """N % 16 != 0: the split-K kernel's 1-byte-load instantiation, grouped
    and per channel."""
    from repro_torch.kernels.w4a16_matmul import splitk_plan

    assert splitk_plan(M, N, 1, 0).vec == 1
    _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [896, 128])
def test_w4a16_splitk_unaligned_weight(cuda, G):
    """A weight whose rows are not 16-byte aligned (N % 16 == 0, storage
    offset 1) takes the 1-byte loads: within W4A16_RTOL of the plain
    version, as the aligned copy's 16-byte loads are (the two sum the
    rows in other orders)."""
    from repro_torch.core.quant import group_quantize, pack_int4
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
    from repro_torch.kernels.w4a16_matmul import (w4a16_matmul_cuda,
                                                  w4a16_matmul_plain)

    gen = torch.Generator(device=cuda).manual_seed(11)
    w_q, w_scale = group_quantize(
        torch.randn((896, 896), generator=gen, device=cuda), G)
    w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
    buf = torch.empty(w_km.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(w_km.shape)
    shifted.copy_(w_km)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    x = torch.randn((8, 896), generator=gen, device=cuda).to(torch.bfloat16)
    want = w4a16_matmul_plain(x, w_km, w_scale, G)
    limit = _chip_smoke().W4A16_RTOL * want.abs().max().item()
    for weight in (shifted, w_km):
        got = w4a16_matmul_cuda(x, weight, w_scale, G)
        assert (got - want).abs().max().item() <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 64, 256])
def test_w4a16_two_calls_bit_equal(cuda, M):
    """No atomics: the same inputs give the same bits, call after call."""
    from repro_torch.core.quant import group_quantize, pack_int4
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
    from repro_torch.kernels.w4a16_matmul import w4a16_matmul_cuda

    gen = torch.Generator(device=cuda).manual_seed(M)
    for K, N in MAIN_KN:
        w = torch.randn((K, N), generator=gen, device=cuda) * 0.02
        x = torch.randn((M, K), generator=gen, device=cuda)
        for G in (K, 128):
            w_q, w_scale = group_quantize(w, G)
            w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
            for dt in (torch.bfloat16, torch.float32):
                first = w4a16_matmul_cuda(x.to(dt), w_km, w_scale, G)
                for _ in range(3):
                    again = w4a16_matmul_cuda(x.to(dt), w_km, w_scale, G)
                    assert torch.equal(first, again), (K, N, G, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 32, 33, 100, 128, 255, 256, 300])
@pytest.mark.parametrize("K,N", MAIN_KN)
def test_w4a16_tensor_cores_every_prefill_row_count(cuda, M, K, N):
    """M > 16 at the main shapes: bf16 x on the tensor-core kernel (f32 x
    on FFMA), per channel and grouped, within W4A16_RTOL."""
    from repro_torch.kernels.w4a16_matmul import prefill_plan

    for G in (K, 128):
        g, Kh = (0, K // 2) if G == K else (G, -(-K // (2 * G)) * G)
        assert prefill_plan(M, K, N, Kh, g).kernel == "mma"
        _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,G", [
    (33, 896, 6, 896), (64, 192, 24, 64), (100, 130, 50, 130),
    (17, 77, 130, 77), (255, 96, 40, 32), (64, 512, 130, 64),
    (300, 192, 24, 32), (40, 192, 96, 48), (64, 904, 896, 904)])
def test_w4a16_tensor_cores_odd_shapes(cuda, M, K, N, G):
    """N = 6, 24, 50, 130 (1-byte weight loads), odd K per channel and K/2
    not a multiple of 8 (2-byte x loads), G = 32, 64 and 48 (16-row
    k-steps): the tensor-core kernel masks its edges."""
    _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [896, 128])
def test_w4a16_tensor_cores_unaligned_operands(cuda, G):
    """At M = 64, an x and a weight whose rows are not 16-byte aligned
    (storage offsets of one element) take the 2-byte and 1-byte loads:
    within W4A16_RTOL of the plain version, alone and together."""
    from repro_torch.core.quant import group_quantize, pack_int4
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
    from repro_torch.kernels.w4a16_matmul import (prefill_plan,
                                                  w4a16_matmul_cuda,
                                                  w4a16_matmul_plain)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0 and out.is_contiguous()
        return out

    gen = torch.Generator(device=cuda).manual_seed(12)
    w_q, w_scale = group_quantize(
        torch.randn((896, 896), generator=gen, device=cuda), G)
    w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
    x = torch.randn((64, 896), generator=gen, device=cuda).to(torch.bfloat16)
    want = w4a16_matmul_plain(x, w_km, w_scale, G)
    limit = _chip_smoke().W4A16_RTOL * want.abs().max().item()
    g = 0 if G == 896 else G
    for xx, ww, vecs in ((shifted(x), w_km, (2, 16)),
                         (x, shifted(w_km), (16, 1)),
                         (shifted(x), shifted(w_km), (2, 1)),
                         (x, w_km, (16, 16))):
        plan = prefill_plan(64, 896, 896, w_km.shape[0], g, True,
                            xx.data_ptr() % 16 == 0, ww.data_ptr() % 16 == 0)
        assert (plan.kernel, plan.x_vec, plan.w_vec) == ("mma", *vecs)
        got = w4a16_matmul_cuda(xx, ww, w_scale, G)
        assert (got - want).abs().max().item() <= limit, vecs


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,G", [(64, 192, 96, 24), (33, 120, 50, 40)])
def test_w4a16_group_not_a_multiple_of_16_takes_ffma(cuda, M, K, N, G):
    """Grouped with G % 16 != 0: a 16-deep MMA step would cross a group,
    so bf16 x runs the FFMA kernel, within W4A16_RTOL."""
    from repro_torch.kernels.w4a16_matmul import prefill_plan

    assert prefill_plan(M, K, N, -(-K // (2 * G)) * G, G).kernel == "ffma"
    _w4a16_check(cuda, M, K, N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(m, k, n) for m in W4A4_M
                                   for k, n in W4A4_KN]
                         + [(1, 2, 2), (3, 5, 2), (7, 13, 10), (33, 57, 34),
                            (129, 511, 130)] + W4A4_ODD)
def test_lut4_and_unfused_int4_kernels_exact(cuda, M, K, N):
    from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                                 int4_matmul_plain)
    from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda

    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a_q = torch.randint(-8, 8, (M, K), generator=gen, device=cuda,
                        dtype=torch.int8)
    a_s = torch.rand((M, 1), generator=gen, device=cuda) + 0.05
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device=cuda, dtype=torch.int8))
    w_s = torch.rand((1, N), generator=gen, device=cuda) + 0.05
    want = int4_matmul_plain(a_q, a_s, w_km, w_s)
    got_lut = lut4_matmul_cuda(a_q, a_s, w_km, w_s)
    got_int = int4_matmul_cuda(a_q, a_s, w_km, w_s)
    assert torch.equal(got_lut, want)
    assert torch.equal(got_int, want)
    assert torch.equal(got_lut, got_int)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,splits,bn", [(8, 4864, 896, 8, 64),
                                             (64, 896, 896, 7, 64),
                                             (256, 4864, 896, 4, 128),
                                             (256, 896, 4864, 1, 128)])
def test_w4a4_entries_split_and_widest_plans(cuda, M, K, N, splits, bn):
    """Each entry under split plans (one cluster of `splits` CTAs a tile,
    64- and 128-column tiles) and under the widest (64 x 128 tiles, one
    split): bit-exact against the plain
    versions, fused and unfused bit-equal on the same a_q and a_scale, and
    two calls bit-equal."""
    from repro_torch.core.quant import quant_scale, quantize
    from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                                 int4_matmul_plain, w4a4_plan)

    plan = w4a4_plan(M, K, N, K // 2)
    assert (plan.splits, plan.bn) == (splits, bn), plan
    gen = torch.Generator(device=cuda).manual_seed(M * N + K)
    x = torch.randn((M, K), generator=gen, device=cuda).to(
        torch.bfloat16).to(torch.float32)
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device=cuda, dtype=torch.int8))
    w_s = torch.rand((1, N), generator=gen, device=cuda) + 0.05
    a_s = quant_scale(x, axis=1, bits=4)
    a_q = quantize(x, a_s, bits=4)
    fused = int4_matmul_fused_cuda(x, w_km, w_s)
    unfused = int4_matmul_cuda(a_q, a_s, w_km, w_s)
    assert torch.equal(fused, int4_matmul_fused_plain(x, w_km, w_s))
    assert torch.equal(unfused, int4_matmul_plain(a_q, a_s, w_km, w_s))
    assert torch.equal(fused, unfused)
    assert torch.equal(fused, int4_matmul_fused_cuda(x, w_km, w_s))
    assert torch.equal(unfused, int4_matmul_cuda(a_q, a_s, w_km, w_s))


@pytest.mark.cuda
def test_w4a4_unaligned_operands_take_narrow_loads(cuda):
    """Operands one element off 16-byte alignment: the plan takes 1-byte
    weight loads and the kernel narrow activation loads, bit-exact."""
    from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                                 int4_matmul_plain, w4a4_plan)

    M, K, N = 8, 896, 896
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((M * K + 1,), generator=gen, device=cuda)[1:].view(M, K)
    a_q = torch.randint(-8, 8, (M * K + 1,), generator=gen, device=cuda,
                        dtype=torch.int8)[1:].view(M, K)
    a_s = torch.rand((M, 1), generator=gen, device=cuda) + 0.05
    w_buf = torch.randint(0, 256, (K // 2 * N + 1,), generator=gen,
                          device=cuda, dtype=torch.uint8)
    w_km = w_buf[1:].view(K // 2, N)
    w_s = torch.rand((1, N), generator=gen, device=cuda) + 0.05
    assert w4a4_plan(M, K, N, K // 2, w_km.data_ptr() % 16 == 0).vec == 1
    assert torch.equal(int4_matmul_fused_cuda(x, w_km, w_s),
                       int4_matmul_fused_plain(x, w_km, w_s))
    assert torch.equal(int4_matmul_cuda(a_q, a_s, w_km, w_s),
                       int4_matmul_plain(a_q, a_s, w_km, w_s))


def _lut4_case(dev, M, K, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a_q = torch.randint(-8, 8, (M, K), generator=gen, device=dev,
                        dtype=torch.int8)
    a_s = torch.rand((M, 1), generator=gen, device=dev) + 0.05
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device=dev, dtype=torch.int8))
    w_s = torch.rand((1, N), generator=gen, device=dev) + 0.05
    return a_q, a_s, w_km, w_s


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(16, 896, 896), (17, 896, 896),
                                   (8, 896, 4864), (256, 896, 4864),
                                   (1, 4864, 896), (64, 4864, 128),
                                   (2, 301, 40), (16, 77, 130),
                                   (17, 511, 34), (300, 1001, 250)])
def test_lut4_both_paths_and_split_counts(cuda, M, K, N):
    """Both paths (M <= 16 and M > 16), with one split and with many (plan
    printed in the assertion), M = 16 / 17 at the path boundary, odd K and
    N not a multiple of 16: bit-equal to the plain version and to the
    unfused W4A4 kernel."""
    from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                                 int4_matmul_plain)
    from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda, lut4_plan

    a_q, a_s, w_km, w_s = _lut4_case(cuda, M, K, N, M * K + N)
    plan = lut4_plan(M, K, N, w_km.shape[0], w_km.data_ptr() % 16 == 0)
    got = lut4_matmul_cuda(a_q, a_s, w_km, w_s)
    assert torch.equal(got, int4_matmul_plain(a_q, a_s, w_km, w_s)), plan
    assert torch.equal(got, int4_matmul_cuda(a_q, a_s, w_km, w_s)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 64, 256])
def test_lut4_two_calls_bit_equal(cuda, M):
    """No atomics across CTAs and integer sums: the same bits call after
    call, at every main-path shape."""
    from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda

    for K, N in MAIN_KN:
        a_q, a_s, w_km, w_s = _lut4_case(cuda, M, K, N, M + N)
        first = lut4_matmul_cuda(a_q, a_s, w_km, w_s)
        assert torch.equal(first, lut4_matmul_cuda(a_q, a_s, w_km, w_s))


@pytest.mark.cuda
def test_lut4_unaligned_weight_takes_byte_loads(cuda):
    """A weight view that starts off a 16-byte boundary (N % 16 == 0) runs
    the 1-byte loads, still bit-exact."""
    from repro_torch.kernels.int4_matmul import int4_matmul_plain
    from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda, lut4_plan

    a_q, a_s, w_km, w_s = _lut4_case(cuda, 8, 896, 896, 5)
    buf = torch.empty(w_km.numel() + 1, dtype=torch.uint8, device=cuda)
    ww = buf[1:].view(w_km.shape)
    ww.copy_(w_km)
    assert lut4_plan(8, 896, 896, 448, ww.data_ptr() % 16 == 0).vec == 1
    assert torch.equal(lut4_matmul_cuda(a_q, a_s, ww, w_s),
                       int4_matmul_plain(a_q, a_s, w_km, w_s))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["onehot", "take"])
def test_lut_mul4_kernel_exact(cuda, strategy):
    from repro_torch.kernels.lut_mul4 import lut_mul4_cuda

    vals = torch.arange(-8, 8, dtype=torch.int8, device=cuda)
    a, b = vals.repeat_interleave(16), vals.repeat(16)
    assert torch.equal(lut_mul4_cuda(a, b, strategy),
                       (a.int() * b.int()).to(torch.int8))
    gen = torch.Generator(device=cuda).manual_seed(3)
    for shape in ((1 << 20,), (5, 33), (2, 3, 130), (1, 1, 1, 257),
                  ((1 << 20) + 7,), (15,)):
        a, b = (torch.randint(-8, 8, shape, generator=gen, device=cuda,
                              dtype=torch.int8) for _ in range(2))
        got = lut_mul4_cuda(a, b, strategy)
        assert got.shape == a.shape
        assert torch.equal(got, (a.int() * b.int()).to(torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1), (1, 0), (3, 5), (15, 15)])
@pytest.mark.parametrize("n", [1, 17, 1000, (1 << 20) + 7])
def test_lut_mul4_kernel_unaligned_operands(cuda, offsets, n):
    """Operands off 16-byte alignment (a[1:] is contiguous at an odd
    address): a shared offset takes 16-byte vectors after a head of bytes,
    differing offsets take bytes throughout; exact either way."""
    from repro_torch.kernels.lut_mul4 import lut_mul4_cuda

    gen = torch.Generator(device=cuda).manual_seed(n)
    oa, ob = offsets
    a, b = (torch.randint(-8, 8, (n + 16,), generator=gen, device=cuda,
                          dtype=torch.int8) for _ in range(2))
    a, b = a[oa:oa + n], b[ob:ob + n]
    got = lut_mul4_cuda(a, b)
    assert got.shape == (n,)
    assert torch.equal(got, (a.int() * b.int()).to(torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("plan,gemm", [
    ("*=w4a16_packed/g32;lm_head=float", "w4a16_matmul"),
    ("*=lut4;lm_head=float", "lut4_matmul"),
    ("mixed_sensitive", "w4a16_matmul")])
def test_engine_plan_paths(cuda, plan, gemm):
    """A 2-layer, head-dim-64 engine under a plan: every request retires ok
    through the plan's GEMM kernel; the W4A4-only plans never launch the
    fused W4A4 kernel."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_plan=plan, cache_dtype="bfloat16")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64)
    engine = InferenceEngine(cfg, rt, sv, device=cuda)
    ops.reset_launch_counts()
    _, fin = run_trace(engine, poisson_trace(6, 1.0, (8, 20), (4, 8),
                                             cfg.vocab, seed=1))
    assert all(r.outcome == "ok" and len(r.tokens) == r.max_new for r in fin)
    n = ops.launch_counts()
    assert n[gemm] > 0, n
    if plan != "mixed_sensitive":
        assert n["int4_matmul_fused"] == 0, n
    else:
        assert n["int4_matmul_fused"] > 0, n


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["w4a16_packed", "*=w4a16_packed/g128"])
def test_w4a16_card_vs_cpu_catches_a_planted_fault(cuda, monkeypatch, plan):
    """chip_smoke.py's W4A16 card-vs-CPU run (2 layers at full width, bf16,
    per channel or grouped G = 128) holds the card within CPU_ATOL of the
    CPU, and the same run fails that limit once the card's kernel gets one
    group's scale doubled: group 0 of every weight (per channel, a weight's
    one group is all of K; grouped, a seventh of K = 896 and 1/38 of
    K = 4864)."""
    from repro_torch.configs import Runtime

    cs = _chip_smoke()
    kw = ({"quant_backend": plan} if "=" not in plan
          else {"quant_plan": plan + ";lm_head=float"})
    rt = Runtime(attn_impl="flash", **kw)
    sound, _ = cs._two_devices(torch, rt)
    err = (sound["cuda"] - sound["cpu"]).abs().max().item()

    kernel = ops.w4a16_matmul_cuda

    def broken(x, w_km, w_scale, group_size, **kwargs):
        w_scale = w_scale.clone()
        w_scale[0] *= 2
        return kernel(x, w_km, w_scale, group_size, **kwargs)

    monkeypatch.setattr(ops, "w4a16_matmul_cuda", broken)
    planted, launches = cs._two_devices(torch, rt)
    err_planted = (planted["cuda"] - planted["cpu"]).abs().max().item()
    print(f"W4A16 {plan} card vs CPU: max |logit diff| sound {err:.6g}, "
          f"group 0 scale x2 {err_planted:.6g} (limit {cs.CPU_ATOL})")
    assert launches["w4a16_matmul"] > 0, launches
    assert err <= cs.CPU_ATOL < err_planted


# ------------------------------------------------- the compiled step ----
def _graph_cases(dev):
    """(name, inputs A, inputs B, fn) for every kernel wrapper of the
    serving paths at serving shapes: the split-K workspaces (W4A16 and lut4
    at M = 8) and their programmatic-dependent-launch reduces, the W4A4
    and decode cluster launches, and flash prefill's shared-memory
    attribute at two buckets, the larger first."""
    gen = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bytes_(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def scale(*shape):
        return torch.rand(shape, generator=gen, device=dev) + 0.05

    cases = []
    for M, (K, N) in ((8, (896, 4864)), (64, (4864, 896))):
        w, ws = bytes_(K // 2, N), scale(1, N)
        cases.append((f"int4_matmul_fused M={M} K={K} N={N}",
                      lambda M=M, K=K: [randn(M, K, dtype=torch.float32)],
                      lambda x, w=w, ws=ws: ops.int4_matmul_fused_kmajor(
                          x, w, ws)))
        cases.append((f"w4a16_matmul M={M} K={K} N={N}",
                      lambda M=M, K=K: [randn(M, K)],
                      lambda x, w=w, ws=ws, K=K: ops.w4a16_matmul_kmajor(
                          x, w, ws, K)))
        cases.append((f"lut4_matmul M={M} K={K} N={N}",
                      lambda M=M, K=K: [torch.randint(
                          -7, 8, (M, K), generator=gen,
                                             device=dev, dtype=torch.int32
                                             ).to(torch.int8),
                               scale(M, 1)],
                      lambda a, s, w=w, ws=ws: ops.lut4_matmul_kmajor(
                          a, s, w, ws)))
    for S in (256, 32):
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        cases.append((f"flash_prefill Sq={S}",
                      lambda S=S: [randn(1, S, H_, 64), randn(1, S, KV_, 64),
                                   randn(1, S, KV_, 64)],
                      lambda q, k, v, pos=pos: ops.flash_prefill(
                          q, k, v, pos, pos)))
    P, ps, pps = 320, 16, 32
    kp, vp = randn(P, ps, KV_, 64), randn(P, ps, KV_, 64)
    tbl = torch.randperm(P, generator=gen, device=dev)[:8 * pps].reshape(
        8, pps).to(torch.int32)

    def last():
        return torch.randint(0, pps * ps, (8,), generator=gen, device=dev,
                             dtype=torch.int32)

    cases.append(("paged_decode_attention B=8",
                  lambda: [randn(8, H_, 64), last()],
                  lambda q, lp: ops.paged_decode_attention(q, kp, vp, tbl,
                                                           lp)))
    slots = torch.arange(64, device=dev, dtype=torch.int32) % 8
    cases.append(("ragged_decode_attention T=64",
                  lambda: [randn(64, H_, 64), last().repeat(8)],
                  lambda q, tp: ops.ragged_paged_attention(q, kp, vp, tbl,
                                                           slots, tp)))
    return cases


H_, KV_ = 14, 2


@pytest.mark.cuda
def test_every_kernel_replays_under_capture(cuda):
    """Each wrapper captured in a CUDA graph (one memory pool for all, as
    the engine's) and replayed on new inputs copied into its static
    buffers gives the eager call's bits, also when replayed again after
    every other graph was captured; the launch counts move only where a
    wrapper runs, and the capture itself launches nothing."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"driver {out}")
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for name, make, fn in _graph_cases(cuda):
        static = make()
        fn(*static)                                    # warm-up
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            result = fn(*static)
        graphs.append((name, make, fn, static, g, result))
        for new in (make(), make()):
            for s, x in zip(static, new):
                s.copy_(x)
            g.replay()
            assert torch.equal(result, fn(*new)), name
    for name, make, fn, static, g, result in graphs:
        new = make()
        for s, x in zip(static, new):
            s.copy_(x)
        ops.reset_launch_counts()
        g.replay()
        torch.cuda.synchronize()
        assert set(ops.launch_counts().values()) == {0}
        assert torch.equal(result, fn(*new)), f"{name}, replayed again"


def _captured_vs_eager(cuda, step, cache_dtype, trace_fn, warm_lens):
    """One trace through the captured engine and an eager one on the same
    weights: (stats, tokens, launches) of each."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.observability import Telemetry
    from repro_torch.serving.api import run_trace
    from repro_torch.serving.engine import InferenceEngine

    cs = _chip_smoke()
    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype=cache_dtype)
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=24, max_ctx=128,
                       step=step)
    out, params = {}, None
    for mode in ("captured", "eager"):
        make = InferenceEngine if mode == "captured" else cs.eager_engine
        eng = make(cfg, rt, sv, params=params, device=cuda,
                   telemetry=Telemetry(strict_recompiles=True))
        params = eng.params
        eng.warmup(warm_lens)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats, fin = run_trace(eng, trace_fn(cfg.vocab))
        torch.cuda.synchronize()
        assert all(r.outcome == "ok" and len(r.tokens) == r.max_new
                   for r in fin)
        out[mode] = (stats, [r.tokens for r in fin], ops.launch_counts(),
                     eng)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("step,cache_dtype", [("bucketed", "bfloat16"),
                                              ("ragged", "int8")])
def test_captured_engine_equals_eager_engine(cuda, step, cache_dtype):
    """Greedy tokens and kernel launch counts of the captured engine equal
    the eager engine's on one trace (with preemption: 24 pages of 16 for
    four requests of up to 90 tokens), every step shape captured once."""
    from repro_torch.serving.api import mixed_trace, poisson_trace

    def trace(vocab):
        if step == "ragged":
            return mixed_trace(8, (8, 20, 50), (8, 40), vocab, seed=2)
        return poisson_trace(8, 1.0, (8, 20, 50), (8, 40), vocab, seed=2)

    out = _captured_vs_eager(cuda, step, cache_dtype, trace, (8, 20, 50))
    (cs, ctok, cn, eng), (es, etok, en, _) = out["captured"], out["eager"]
    assert ctok == etok
    assert cn == en, (cn, en)
    assert cs["recompiles"]["steady_state"] == 0
    assert cs["recompiles"]["total"] == sum(
        s._cache_size() for s in (eng._prefill, eng._prefill_tail,
                                  eng._decode, eng._ragged) if s is not None)
    assert cs["recompiles"]["by_fn"] == es["recompiles"]["by_fn"]


@pytest.mark.cuda
def test_captured_engine_mid_run_bucket_is_a_compile(cuda):
    """A prompt bucket first hit mid-run (warmup covers 8 and 16 tokens,
    the trace brings 50) is captured then: a compile, never a steady-state
    recompile (the engine's sentinel is strict)."""
    from repro_torch.serving.api import poisson_trace

    out = _captured_vs_eager(
        cuda, "bucketed", "bfloat16",
        lambda vocab: poisson_trace(6, 1.0, (8, 12, 50), (6,), vocab,
                                    seed=3), (8, 12))
    (cs, ctok, _, eng), (_, etok, _, _) = out["captured"], out["eager"]
    assert ctok == etok
    rec = cs["recompiles"]
    mid = [e for e in rec["events"] if e["step"] > 0]
    assert any(e["fn"] == "prefill" and e["shape"] == [1, 64] for e in mid)
    assert rec["steady_state"] == 0
    assert not any(e["steady_state"] for e in rec["events"])
    assert eng._prefill._cache_size() == rec["by_fn"]["prefill"]


@pytest.mark.cuda
def test_shared_prefix_captures_prefill_tail_bit_equal_to_eager(cuda):
    """Shared-prefix traffic on the card: prefix hits run the tail-prefill
    step (flash over the gathered cached pages) under capture, and the
    captured engine emits the eager engine's tokens and launches; each
    tail-prefill graph replayed on its last inputs gives the eager step's
    tokens."""
    from repro_torch.serving.api import shared_prefix_trace

    out = _captured_vs_eager(
        cuda, "bucketed", "bfloat16",
        lambda vocab: shared_prefix_trace(6, 1.0, 32, (8, 20), (6,), vocab,
                                          seed=4), (8, 20, 40, 52))
    (cs, ctok, cn, eng), (es, etok, en, _) = out["captured"], out["eager"]
    assert ctok == etok
    assert cn == en and cn["flash_prefill"] > 0
    assert cs["tokens_prefilled_saved"] > 0
    assert cs["tokens_prefilled_saved"] == es["tokens_prefilled_saved"]
    assert cs["recompiles"]["by_fn"]["prefill_tail"] >= 1
    assert cs["recompiles"]["steady_state"] == 0
    tail = eng._prefill_tail
    for g in tail._graphs.values():
        g.graph.replay()
        replayed = g.out.clone()
        tokens, positions, slots = g.static
        want, _ = tail.fn(eng.params, tokens, eng.caches, positions,
                          eng._tbl, slots)
        assert torch.equal(replayed, want)


@pytest.mark.cuda
def test_captured_engine_cancel_and_restore_on_card(cuda):
    """A captured engine cancels a request mid-decode, is snapshotted and
    restored (a new engine, whose steps capture again at first use), and a
    second restore goes into an engine warmed up beforehand, whose pool
    and table pool keep their storage: the survivors' tokens equal an
    uninterrupted captured run with the same cancel."""
    import gc
    import weakref

    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.observability import Telemetry
    from repro_torch.serving.engine import InferenceEngine, _pool_leaves

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="bfloat16")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=24, max_ctx=128)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in (12, 30, 20, 9)]
    params = None

    def engine():
        nonlocal params
        eng = InferenceEngine(cfg, rt, sv, params=params, device=cuda,
                              telemetry=Telemetry(strict_recompiles=True))
        params = eng.params
        eng.warmup((12, 30))
        return eng

    def start(eng):
        for p in prompts:
            eng.submit(p, 12)
        for _ in range(3):
            eng.step()
        assert eng.cancel(1)                   # mid-decode
        eng.step()

    def drain(eng, out):
        eng.run_until_idle()
        for r in eng.collect():
            out[r.rid] = (r.outcome, list(r.tokens))
        return out

    ref = engine()
    start(ref)
    want = drain(ref, {})
    del ref
    eng = engine()
    start(eng)
    out = {}
    for r in eng.collect():
        out[r.rid] = (r.outcome, list(r.tokens))
    snap = eng.snapshot()
    old = weakref.ref(eng)
    eng = InferenceEngine.restore(snap, params=params)
    gc.collect()
    assert old() is None
    eng.step()
    snap2 = eng.snapshot()
    warm = engine()                            # captured before the load
    ptrs = [t.data_ptr() for _, t in _pool_leaves(warm.caches)]
    tbl = warm._tbl.data_ptr()
    warm._load_snapshot(snap2)
    assert [t.data_ptr() for _, t in _pool_leaves(warm.caches)] == ptrs
    assert warm._tbl.data_ptr() == tbl
    assert drain(eng, dict(out)) == want        # the first restore drains
    assert drain(warm, out) == want
    assert want[1][0] == "cancelled"
    assert warm.stats()["recompiles"]["steady_state"] == 0


# ------------------------------------------------- the circuit and widths --
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "init"])
def test_netlist_on_the_card_equals_the_cpu(cuda, mode):
    """The simulated circuit on CUDA operands computes on the card and
    gives the CPU's products (all of them a * b)."""
    from repro_torch.core import build_acc_mult4, build_proposed_mult4

    a = torch.from_numpy(RNG.integers(0, 16, (1 << 16,), dtype=np.uint8))
    b = torch.from_numpy(RNG.integers(0, 16, (1 << 16,), dtype=np.uint8))
    for nl in (build_proposed_mult4(), build_acc_mult4()):
        got = nl(a.to(cuda), b.to(cuda), mode=mode)
        assert got.is_cuda and got.dtype == torch.uint8
        assert torch.equal(got.cpu(), nl(a, b, mode=mode))
        assert torch.equal(got.cpu(), (a.int() * b.int()).to(torch.uint8))


@pytest.mark.cuda
def test_netlist_qdense_equals_int_sim_on_the_card(cuda):
    """The gate-level oracle equals the fused W4A4 kernel bit for bit on
    the card, and its own CPU result, on plain random inputs: the quantize
    scales divide with IEEE rounding on both devices, so the card's int4
    values are the CPU's."""
    from repro_torch.core.qlinear import QuantConfig, qdense

    w = torch.from_numpy(RNG.standard_normal((256, 72)).astype(np.float32))
    x = torch.from_numpy(RNG.standard_normal((16, 256)).astype(np.float32))
    net = qdense(w.to(cuda), x.to(cuda), QuantConfig(backend="netlist"))
    ops.reset_launch_counts()
    fused = qdense(w.to(cuda), x.to(cuda), QuantConfig(backend="int_sim"))
    assert ops.launch_counts()["int4_matmul_fused"] == 1
    assert net.is_cuda and torch.equal(net, fused)
    assert torch.equal(net.cpu(), qdense(w, x, QuantConfig(backend="netlist")))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["int_sim/a8", "int_sim/w8/a8", "lut4/a8",
                                  "pallas_int4/w8/a8", "w4a4_packed/a8",
                                  "w4a16/w8"])
@pytest.mark.parametrize("M", [16, 17])
def test_widths_on_the_card_at_the_int_mm_boundary(cuda, spec, M):
    """Widths no kernel serves at 16 and 17 rows (``torch._int_mm`` runs
    only above 16: the route pads), held to chip_smoke's float64 reference
    (`width_call`): the integer routes bit for bit, w4a16/w8 within
    W8_RTOL relative; every result stays on the card and no kernel
    launches."""
    cs = _chip_smoke()
    K, N = 896, 132
    w = torch.from_numpy(RNG.standard_normal((K, N)).astype(np.float32)
                         ).to(cuda)
    x = torch.from_numpy(RNG.standard_normal((M, K)).astype(np.float32)
                         ).to(cuda)
    ops.reset_launch_counts()
    got, err = cs.width_call(torch, spec, w, x)
    assert got.is_cuda and err <= cs.W8_RTOL, err
    assert sum(ops.launch_counts().values()) == 0


# ------------------------------------------- contiguous layout, Mamba-2 ----
@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 17, 96, 256])
@pytest.mark.parametrize("K,N", [(768, 3352), (1536, 768)])
def test_int4_kernel_bit_exact_at_mamba_shapes(cuda, M, K, N):
    """mamba2-130m's in_proj (N = 3352: N % 16 = 8, the 1-byte weight
    loads) and out_proj, at decode rows and prompt lengths."""
    test_int4_kernel_bit_exact(cuda, M, K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 256), (4096, 12288),
                                 (12288, 4096)])
def test_int4_kernel_bit_exact_at_hybrid_shapes(cuda, M, K, N):
    """recurrentgemma-9b's projections (the RG-LRU's five and the
    attention's wq / wo at (4096, 4096), wk / wv at (4096, 256), the FFN's
    at (4096, 12288) and (12288, 4096): the longest K the kernel meets) at
    the decode batch and the 256-token prompt."""
    test_int4_kernel_bit_exact(cuda, M, K, N)


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _copy_tree(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree(v, src[k])
        else:
            v.copy_(src[k])


def _trees_equal(a, b):
    return all(_trees_equal(v, b[k]) if isinstance(v, dict)
               else torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b",
                                  "recurrentgemma-9b"])
def test_captured_contiguous_steps_replay_equal_eager(cuda, arch):
    """The contiguous layout's steps on the card (reduced mamba2-130m and
    the reduced hybrid recurrentgemma-9b, its 5 layers at head dim 256
    with its 16-slot window wrapping, with exact-length prefill; reduced
    qwen2-0.5b with bucketed prefill; W4A4):
    the captured engine emits the eager engine's tokens and launches, and
    every captured graph (each exact-length prefill and each decode
    bucket) replayed on its last inputs gives the eager step's tokens and
    leaves the engine's cache tree as the eager step does, from the same
    state."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.observability import Telemetry
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cs = _chip_smoke()
    cfg = (get_config(arch).reduced(head_dim=256)
           if arch == "recurrentgemma-9b"
           else get_config(arch).reduced(n_layers=2, head_dim=64))
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
    sv = ServingConfig(layout="contiguous", max_batch=4, max_ctx=96)
    lens = (7, 20, 33)
    out, params = {}, None
    for mode in ("captured", "eager"):
        make = InferenceEngine if mode == "captured" else cs.eager_engine
        eng = make(cfg, rt, sv, params=params, device=cuda,
                   telemetry=Telemetry(strict_recompiles=True))
        params = eng.params
        eng.warmup(lens)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats, fin = run_trace(eng, poisson_trace(8, 1.0, lens, (5, 12),
                                                  cfg.vocab, seed=7))
        torch.cuda.synchronize()
        assert all(r.outcome == "ok" and len(r.tokens) == r.max_new
                   for r in fin)
        out[mode] = ([r.tokens for r in fin], ops.launch_counts(), stats,
                     eng)
    (ctok, cn, cstats, eng), (etok, en, _, _) = out["captured"], \
        out["eager"]
    assert ctok == etok and cn == en
    assert cstats["recompiles"]["steady_state"] == 0
    n_prefill = len(lens) if arch != "qwen2-0.5b" else len(
        {sv.prompt_bucket(n) for n in lens})
    assert eng._prefill._cache_size() == n_prefill
    assert eng._decode._cache_size() == len(sv.buckets)
    for step in (eng._prefill, eng._decode):
        for g in step._graphs.values():
            before = _clone_tree(eng.caches)
            g.graph.replay()
            replayed, after = g.out.clone(), _clone_tree(eng.caches)
            _copy_tree(eng.caches, before)
            tokens, positions, slots = g.static
            want, _ = step.fn(eng.params, tokens, eng.caches, positions,
                              None, slots)
            assert torch.equal(replayed, want)
            assert _trees_equal(after, eng.caches)


# ------------------------------------ GELU FFN, sinusoidal stacks, MoE ----
@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 256])
@pytest.mark.parametrize("K,N", [(4608, 4608), (4608, 512), (4608, 18432),
                                 (18432, 4608), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (7168, 7168), (7168, 1024),
                                 (7168, 4864), (4864, 7168), (5120, 5120),
                                 (5120, 1024), (5120, 8192), (8192, 5120)])
def test_int4_kernel_bit_exact_at_gelu_and_moe_shapes(cuda, M, K, N):
    """starcoder2-7b's projections (K = 18432, the longest a paged config
    runs), musicgen-large's, arctic-480b's attention and dense residual FFN
    and llama4-maverick's attention and shared expert."""
    test_int4_kernel_bit_exact(cuda, M, K, N)


#: reduced configs at the head dims and query groups of their full widths
#: (the attention kernels are built for hd 64 and 128 only)
CARD_REDUCED = {
    "starcoder2-7b": dict(head_dim=128, n_heads=18, n_kv_heads=2),
    "musicgen-large": dict(head_dim=64, n_heads=4, n_kv_heads=4),
    "arctic-480b": dict(head_dim=128, n_heads=14, n_kv_heads=2),
    "llama4-maverick-400b-a17b": dict(head_dim=128, n_heads=10,
                                      n_kv_heads=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CARD_REDUCED))
def test_engine_gelu_and_moe_reduced_captured_equals_eager(cuda, arch):
    """Reduced starcoder2-7b (GELU FFN with biases, G = 9), musicgen-large
    (sinusoidal positions, G = 1), arctic-480b (top-2 MoE beside a dense
    FFN, G = 7) and llama4-maverick (top-1 MoE beside a shared expert,
    G = 5), 2 layers, W4A4 (experts packed), on the paged bucketed step:
    the captured engine emits the eager engine's tokens and launches, the
    W4A4 GEMM runs 6 (GELU) or 7 times a layer a forward, and flash
    prefill and paged decode once a layer a forward."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cs = _chip_smoke()
    cfg = get_config(arch).reduced(n_layers=2, **CARD_REDUCED[arch])
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64)
    per_layer = cs.gemms_a_block("A", cfg)
    assert per_layer == (6 if cfg.ffn_type == "gelu" else 7)
    out, params = {}, None
    for mode in ("captured", "eager"):
        make = InferenceEngine if mode == "captured" else cs.eager_engine
        eng = make(cfg, rt, sv, params=params, device=cuda)
        params = eng.params
        ops.reset_launch_counts()
        _, fin = run_trace(eng, poisson_trace(6, 1.0, (8, 20), (4, 8),
                                              cfg.vocab, seed=4))
        torch.cuda.synchronize()
        assert all(r.outcome == "ok" and len(r.tokens) == r.max_new
                   for r in fin)
        assert all(0 <= t < cfg.vocab for r in fin for t in r.tokens)
        out[mode] = ([r.tokens for r in fin], ops.launch_counts())
    (ctok, n), (etok, en) = out["captured"], out["eager"]
    assert ctok == etok and n == en
    forwards = n["int4_matmul_fused"] // (per_layer * 2)
    assert n["int4_matmul_fused"] == per_layer * 2 * forwards > 0, n
    assert n["flash_prefill"] + n["paged_decode_attention"] \
        == 2 * forwards, n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("rows", [3, 64])
def test_moe_block_on_the_card(cuda, arch, rows):
    """The MoE block on the card (reduced, packed experts, bf16): two calls
    bit-equal, the routed expert ids equal to the CPU's on the same
    weights, the experts' one-kernel dequantize equal to the two-step
    formula, and y within 1e-5 of the CPU's in float32, with a few rows
    (only their experts run) and with more rows than experts."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import tree_to
    from repro_torch.core.quant import unpack_int4
    from repro_torch.core.quant_plan import layer_slice
    from repro_torch.models import moe
    from repro_torch.serving.engine import build_params

    cfg = get_config(arch).reduced(n_layers=1)
    params = layer_slice(build_params(
        cfg, Runtime(quant_backend="w4a4_packed"), seed=5,
        device=cuda)["layers"]["u0"]["moe"], 0)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, cfg.d_model), generator=gen, device=cuda)
    for dtype in ("bfloat16", "float32"):
        rt = Runtime(quant_backend="w4a4_packed", compute_dtype=dtype)
        xd = x.to(getattr(torch, dtype))
        got = {}
        for dev, p, xx in (("cuda", params, xd),
                           ("cpu", tree_to(params, "cpu"), xd.cpu())):
            route = {}
            got[dev] = (moe._moe_shard(
                xx, p["router"]["w"], p["experts"], e_start=0,
                n_local=cfg.n_experts, cfg=cfg, rt=rt, dispatch=route)[0],
                route["idx"])
        again = moe._moe_shard(xd, params["router"]["w"], params["experts"],
                               e_start=0, n_local=cfg.n_experts, cfg=cfg,
                               rt=rt)[0]
        assert torch.equal(again, got["cuda"][0])
        assert torch.equal(got["cuda"][1].cpu(), got["cpu"][1])
        # the one-kernel dequantize rounds as the two-step formula does
        w, ids = params["experts"]["w_in"], got["cuda"][1].flatten()
        assert torch.equal(
            moe._dense(w, ids, None, xd.dtype),
            (unpack_int4(w["packed"][ids]).float() * w["scale"][ids]).to(
                xd.dtype))
        if dtype == "float32":
            err = (got["cuda"][0].cpu() - got["cpu"][0]).abs().max().item()
            assert err <= 1e-5, err


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three train steps of reduced qwen2-0.5b at 2 layers, float32 under
    fake_quant, on the card and on the CPU from the same state and
    batches: the loss and grad norm within relative 1e-4 each step, the
    parameters within 1e-4 of each leaf's norm (the key bias, whose exact
    gradient is zero, within twice the summed rates; see
    tests/test_torch_train.py)."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import tree_to
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import warmup_cosine
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2)
    rt = Runtime(attn_impl="chunked", attn_chunk_q=16, loss_chunk=0,
                 quant_backend="fake_quant", compute_dtype="float32",
                 remat="none")
    kw = dict(peak_lr=3e-3, warmup=2, total_steps=3)
    step = make_train_step(cfg, rt, **kw)
    card = init_train_state(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu = tree_to(card, "cpu")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, global_batch=2)
    for i in range(3):
        tokens = torch.from_numpy(ds.batch(i))
        card, mc = step(card, tokens.to(cuda))
        cpu, mp = step(cpu, tokens)
        for k in ("loss", "grad_norm"):
            assert abs(float(mc[k]) - float(mp[k])) <= 1e-4 * abs(
                float(mp[k])), (i, k, float(mc[k]), float(mp[k]))
    assert all(t.device.type == "cuda" for t in tree_leaves(card))
    lr_sum = sum(float(warmup_cosine(i, peak_lr=kw["peak_lr"],
                                     warmup_steps=kw["warmup"],
                                     total_steps=kw["total_steps"]))
                 for i in range(3))
    from repro_torch.checkpoint.ckpt import _flatten

    fc, fp = _flatten(card["params"]), _flatten(cpu["params"])
    for k, want in fp.items():
        got = fc[k].cpu()
        if k.endswith("wk_bias"):
            assert (got - want).abs().max() <= 2 * lr_sum, k
        else:
            assert (got - want).norm() <= 1e-4 * want.norm(), k


@pytest.mark.cuda
def test_quantized_checkpoint_restored_and_served_on_the_card(cuda,
                                                              tmp_path):
    """A serve_w4a4 quantized checkpoint of reduced f32 masters (head dim
    64, which the attention kernels take) restored on the card: the plan
    checked, the kernels' planar twins rebuilt, logits bit-equal to the
    plan packed from the same masters in memory, and the engine's bucketed
    path through the W4A4 GEMM, flash prefill and paged decode."""
    from repro_torch.checkpoint import restore_quantized, save_quantized
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.convert import tree_to
    from repro_torch.core.qlinear import prepack_tree
    from repro_torch.core.quant_plan import CKPT_PACKED, get_plan, \
        plan_pack_tree
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, head_dim=64)
    rt = Runtime(attn_impl="flash", quant_plan="serve_w4a4")
    masters = init_model(torch.Generator().manual_seed(3), cfg)
    save_quantized(str(tmp_path), 0, masters, cfg, rt=rt)
    params, _ = restore_quantized(str(tmp_path), cfg=cfg, rt=rt,
                                  device=cuda)
    wq = params["layers"]["u0"]["attn"]["wq"]
    assert wq["packed_km"].device.type == "cuda"
    ref = prepack_tree(tree_to(plan_pack_tree(
        masters, cfg, get_plan("serve_w4a4"), backends=CKPT_PACKED,
        scale_dtype=torch.bfloat16), cuda))
    tokens = torch.randint(0, cfg.vocab, (1, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        la = forward(params, tokens.to(cuda), cfg, rt)[0]
        lb = forward(ref, tokens.to(cuda), cfg, rt)[0]
    assert torch.equal(la, lb)
    sv = ServingConfig(max_batch=4, page_size=16, num_pages=32, max_ctx=64)
    engine = InferenceEngine(cfg, rt, sv, params=params, device=cuda)
    ops.reset_launch_counts()
    _, fin = run_trace(engine, poisson_trace(4, 1.0, (8, 20), (4, 8),
                                             cfg.vocab, seed=2))
    assert all(r.outcome == "ok" and len(r.tokens) == r.max_new for r in fin)
    n = ops.launch_counts()
    assert all(n[k] > 0 for k in ("int4_matmul_fused", "flash_prefill",
                                  "paged_decode_attention")), n


# ------------------------------------------------ the attention plan search --
#: the decode splits' shapes: qwen2-0.5b's (G = 7 at hd 64) and
#: starcoder2-7b's (G = 9 at hd 128); a 512-token table of 16-token pages
#: (the main path's), rows ending on every split's edges
SPLIT_SHAPES = [(14, 2, 64), (36, 4, 128)]
SPLIT_LAST = [511, 63, 64, -1, 300, 175, 0, 200]


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=["hd64", "hd128"])
def test_every_decode_split_on_both_kernels(cuda, cache_dtype, shape):
    """Every candidate split of ``"attn.paged_decode"`` (1 to 8 CTAs a
    row, ``autotune.candidate_plans``) on both decode kernels: within ATOL
    of the plain version with and without a window, idle rows exactly
    zero, two calls bit-equal, a decode-only ragged pack bit-equal to the
    paged decode kernel, and a mixed pack (decode rows, a prefill chunk,
    padding) within ATOL of the ragged plain version, padding exactly
    zero."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_attention import POOL_NAMES

    H, KV, hd = shape
    ps, pps = 16, 32
    B = len(SPLIT_LAST)
    P = B * pps + 3
    k, v, ks, vs = _pools((P, ps, KV, hd), cache_dtype, cuda)
    tbl = torch.from_numpy(_table(B, pps, P, ps, SPLIT_LAST)).to(cuda)
    lp = torch.tensor(SPLIT_LAST, dtype=torch.int32, device=cuda)
    q = _bf(RNG.standard_normal((B, H, hd)).astype(np.float32), cuda)
    slots = torch.arange(B, dtype=torch.int32, device=cuda)
    chunk = list(range(100, 124))
    mslot = torch.tensor(list(range(B)) + [4] * len(chunk) + [-1] * 4,
                         dtype=torch.int32, device=cuda)
    mpos = torch.tensor(SPLIT_LAST + chunk + [-1] * 4, dtype=torch.int32,
                        device=cuda)
    mq = _bf(RNG.standard_normal((len(mslot), H, hd)).astype(np.float32),
             cuda)
    cands = autotune.candidate_plans("attn.paged_decode", KV, pps * ps, hd,
                                     POOL_NAMES[k.dtype], ps)
    assert sorted(c["nsplit"] for c in cands) == list(range(1, 9))
    for entry in cands:
        for window in (0, 100):
            got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                              window=window, plan=entry)
            again = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                                window=window, plan=entry)
            want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs,
                                                window=window)
            rag = ragged_decode_attention_cuda(q, k, v, tbl, slots, lp, ks,
                                               vs, window=window, plan=entry)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL, (entry, window, err)
            assert torch.equal(got, again), entry
            assert torch.equal(got, rag), entry
            assert not got[3].float().any()
            mixed = ragged_decode_attention_cuda(mq, k, v, tbl, mslot, mpos,
                                                 ks, vs, window=window,
                                                 plan=entry)
            mwant = ragged_decode_attention_plain(mq, k, v, tbl, mslot, mpos,
                                                  ks, vs, window=window)
            err = (mixed.float() - mwant.float()).abs().max().item()
            assert err <= ATOL, (entry, window, err)
            assert not mixed[(mslot < 0) | (mpos < 0)].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["g7_hd128", "g8_window", "sq256",
                                   "sq256_tail", "g16_hd256_tail_window"])
def test_every_flash_plan_matches_plain(cuda, shape):
    """Every candidate plan of ``"attn.prefill"`` (each (rows, key split)
    the kernel takes at the shape) against the plain version: within
    ATOL, padding rows exactly zero, two calls bit-equal."""
    from repro_torch.kernels import autotune

    B, Sq, Skv, H, KV, hd, pads, hit, window = FLASH_SHAPES[shape]
    q = _bf(RNG.standard_normal((B, Sq, H, hd)).astype(np.float32), cuda)
    k = _bf(RNG.standard_normal((B, Skv, KV, hd)).astype(np.float32), cuda)
    v = _bf(RNG.standard_normal((B, Skv, KV, hd)).astype(np.float32), cuda)
    qpos, kpos = (torch.from_numpy(p).to(cuda)
                  for p in _flash_positions(B, Sq, Skv, pads, hit))
    want = flash_prefill_plain(q, k, v, qpos, kpos, window=window)
    cands = autotune.candidate_plans("attn.prefill", (B, Sq), Skv, (H, hd),
                                     "bfloat16", KV)
    assert len(cands) == (2 if hd == 256 else 9)
    for entry in cands:
        got = flash_prefill_cuda(q, k, v, qpos, kpos, window=window,
                                 plan=entry)
        again = flash_prefill_cuda(q, k, v, qpos, kpos, window=window,
                                   plan=entry)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL, (entry, err)
        assert torch.equal(got, again), entry
        for b, pad in enumerate(pads):
            assert not got[b, :pad].float().any(), entry
