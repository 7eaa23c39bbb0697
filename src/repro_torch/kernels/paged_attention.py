"""Paged decode attention and flash prefill: the CUDA kernels
(``csrc/paged_decode.cu``, ``csrc/flash_prefill.cu``) and their plain
PyTorch versions.

Ports ``repro/kernels/paged_attention.py``:

``paged_decode_attention``
    One-token attention per batch row read straight out of the page pool
    ``[P, ps, KV, hd]`` through the block table ``[B, pages_per_seq]``.
    Sentinel table entries (== P) are clamped and their positions masked;
    positions past ``last_pos`` (and rows with ``last_pos == -1``) are
    masked, inactive rows output zeros.  int8 pools and int4 pools
    (``[..., hd // 2]`` uint8 nibble pairs) carry f32 scales
    ``[P, ps, KV, 1]`` and dequantize per page as ``(q.f32 * scale) ->
    bf16`` (``_dequant_slab``), the rounding of
    ``models.attention.dequantize_kv``.  The plain version copies the JAX
    package's two-pass XLA twin (blocked QK into a score buffer, the exact
    softmax with the probabilities cast to the pool dtype, bf16 for a
    quantized pool, blocked PV with f32 partial sums); the CUDA kernel
    splits each row's context across the CTAs of a thread-block cluster
    (``decode_plan``, or the tuned split of ``"attn.paged_decode"``), runs an online softmax in each split, merges the
    splits in a fixed order, and agrees with the plain version to bf16
    tolerance.  The kernel takes bf16, int8 and int4 pools; the plain
    version f32 pools as well.

``flash_prefill``
    Tiled causal GQA attention over the in-flight prompt, masks from the
    explicit position vectors (-1 = padding), online softmax in f32.  The
    plain version copies ``flash_prefill_xla`` with its kv tile.  The
    kernel runs QK and PV on bf16 tensor cores over the (query, head) rows
    of one KV head, several warps a 16-row tile each taking a slice of
    every K/V tile, cut into CTAs by ``flash_plan`` (or the tuned plan of
    ``"attn.prefill"``).

With bf16 activations the QK scores are rounded to bf16 before the scale,
as the dense path's bf16 einsum rounds them.  ``kernels.ops`` picks the
plain version for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..core.quant import unpack_int4
from . import _build, autotune

NEG_INF = -1e30


def _round_scores(s: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """f32-accumulated QK -> the dense path's score values: bf16
    activations round the product to bf16 before the f32 softmax."""
    if compute_dtype == torch.bfloat16:
        s = s.to(torch.bfloat16)
    return s.to(torch.float32)


def _dequant_slab(kq: torch.Tensor, scale, hd: int) -> torch.Tensor:
    """Pool slab [..., hd or hd // 2] -> bf16 with the rounding of
    ``models.attention.dequantize_kv`` (int4 nibbles interleave along hd);
    a float pool passes through."""
    if kq.dtype == torch.uint8:
        kq = unpack_int4(kq, axis=-1)
    if kq.dtype == torch.int8:
        return (kq.to(torch.float32) * scale).to(torch.bfloat16)
    return kq


# ------------------------------------------------------- decode (paged) ----
def paged_decode_attention_plain(q, k_pool, v_pool, tbl, last_pos,
                                 k_scale=None, v_scale=None, window: int = 0,
                                 pp: int = 4) -> torch.Tensor:
    """Two-pass plain version (``paged_decode_attention_xla``):

      1. blocked QK into a [B, KV, G, S] f32 score buffer, pp pages a block,
         each block dequantized when the pool carries scales,
      2. the exact softmax, probabilities cast to the pool dtype (bf16 for
         a quantized pool),
      3. blocked PV with f32 partial sums.

    Both loops stop at the block holding the batch's last active position.
    Reading that position costs one device->host sync on a CUDA tensor;
    this version is the CPU path and the kernel's yardstick, not a hot
    path on the card."""
    B, H, hd = q.shape
    P, ps, KV = k_pool.shape[:3]
    pps = tbl.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cd = q.dtype
    quant = k_scale is not None

    pp = max(1, min(pp, pps))
    nj = -(-pps // pp)
    tokens = pp * ps
    S = nj * tokens
    tbl_p = torch.full((B, nj * pp), P, dtype=torch.int32, device=tbl.device)
    tbl_p[:, :pps] = tbl.to(torch.int32)
    # out-of-bounds sentinel entries gather the last page (jnp indexing
    # clamps); their positions lie past last_pos and mask away
    tbl_p = tbl_p.clamp(max=P - 1).long()
    last_pos = last_pos.to(torch.int32)
    q4 = q.reshape(B, KV, G, hd)
    steps = min(max((int(last_pos.max()) + tokens) // tokens, 1), nj)

    sbuf = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32,
                      device=q.device)
    for j in range(steps):
        cols = tbl_p[:, j * pp:(j + 1) * pp]                 # [B, pp]
        kb = k_pool[cols]                          # [B, pp, ps, KV, hd(/2)]
        if quant:
            kb = _dequant_slab(kb, k_scale[cols], hd)
        kb = kb.reshape(B, tokens, KV, hd)
        s = torch.einsum("bkgh,btkh->bkgt", q4, kb.to(cd))
        sbuf[..., j * tokens:(j + 1) * tokens] = _round_scores(s, cd) * scale

    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = (pos[None, :] <= last_pos[:, None]) & (last_pos >= 0)[:, None]
    if window:
        mask &= (last_pos[:, None] - pos[None, :]) < window
    sbuf = torch.where(mask[:, None, None, :], sbuf, NEG_INF)
    probs = torch.softmax(sbuf, dim=-1).to(
        torch.bfloat16 if quant else v_pool.dtype)

    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=q.device)
    for j in range(steps):
        cols = tbl_p[:, j * pp:(j + 1) * pp]
        vb = v_pool[cols]
        if quant:
            vb = _dequant_slab(vb, v_scale[cols], hd)
        vb = vb.reshape(B, tokens, KV, hd)
        p = probs[..., j * tokens:(j + 1) * tokens]
        acc = acc + torch.einsum("bkgt,btkh->bkgh", p.to(torch.float32),
                                 vb.to(torch.float32))
    acc = acc * (last_pos >= 0)[:, None, None, None]
    return acc.reshape(B, H, hd).to(q.dtype)


#: the decode kernels' split rule (csrc/decode_common.cuh MIN_SPLIT_TOK,
#: MAX_SPLITS): a split holds at least this many tokens (or the whole table)
DECODE_MIN_SPLIT_TOK = 64
#: ... and a row takes at most this many CTAs, one cluster (the portable
#: cluster size)
DECODE_MAX_SPLITS = 8
#: tokens a CTA stages in shared memory per round (decode_common.cuh CHUNK)
DECODE_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the decode kernels cut a row's context: split r of nsplit holds
    positions [r * split_tok, (r + 1) * split_tok) of the table, and the
    nsplit CTAs of a (row, KV head) form one thread-block cluster."""
    split_tok: int  # tokens a split: a multiple of ps
    nsplit: int     # CTAs a row (grid z, the cluster size)
    pages: int      # table entries a CTA loads: split_tok // ps


@functools.lru_cache(maxsize=None)
def decode_plan(width: int, ps: int) -> DecodePlan:
    """The rule's split of a block table `width` = pps * ps tokens wide
    (pages of ps tokens), from the width alone, so the paged and ragged
    kernels cut a table the same way and the wrapper needs nothing from the
    device: the fewest tokens a split, rounded up to whole pages, with at
    most DECODE_MAX_SPLITS splits of at least min(DECODE_MIN_SPLIT_TOK,
    width) tokens.  At max_ctx 512 and ps 16: 8 splits of 64 tokens.
    Mirrors ``split_plan`` in csrc/decode_common.cuh."""
    if width < 1 or ps < 1 or width % ps:
        raise ValueError(f"decode_plan: width {width}, page size {ps}")
    lo = max(-(-width // DECODE_MAX_SPLITS), min(DECODE_MIN_SPLIT_TOK, width))
    split_tok = -(-lo // ps) * ps
    return DecodePlan(split_tok, -(-width // split_tok), split_tok // ps)


def decode_static_smem(hd: int) -> int:
    """A decode CTA's static shared memory at head dim `hd`
    (csrc/decode_common.cuh ``Smem<HD, MAXG>``: the staged K/V chunk, q,
    the chunk's scores and the merge's inbox)."""
    G = DECODE_MAX_GROUP[hd]
    return 2 * DECODE_CHUNK * (hd + 8) * 2 + 4 * (
        G * hd + G * DECODE_CHUNK + 2 * DECODE_MAX_SPLITS * G + G * hd
        + DECODE_MAX_SPLITS)


def decode_split_ok(width: int, ps: int, split_tok: int,
                    nsplit: int) -> bool:
    """Is (split_tok, nsplit) a split the decode kernels take for a table
    `width` tokens wide: whole pages a split, no wider than the table,
    nsplit = ceil(width / split_tok) CTAs a row, at most
    DECODE_MAX_SPLITS (one portable cluster)?  Mirrors ``plan_ok`` in
    csrc/decode_common.cuh."""
    if width < 1 or ps < 1 or width % ps:
        return False
    if split_tok < ps or split_tok % ps or split_tok > width:
        return False
    return nsplit == -(-width // split_tok) and 1 <= nsplit \
        <= DECODE_MAX_SPLITS


def decode_plan_from(entry: dict, width: int, ps: int,
                     hd: int) -> DecodePlan:
    """The split of a tuned entry ({split_tok[, nsplit]}) for a table
    `width` tokens wide at head dim `hd`; ValueError unless the kernels
    take it (`decode_split_ok`) with its table entries beside the static
    shared memory in a CTA's MAX_SMEM_BYTES."""
    split_tok = autotune.int_field(entry, "split_tok")
    if hd not in DECODE_MAX_GROUP or split_tok < 1:
        raise ValueError(f"decode plan: head dim {hd}, split of "
                         f"{split_tok} tokens")
    nsplit = autotune.int_field(entry, "nsplit", -(-width // split_tok))
    if not decode_split_ok(width, ps, split_tok, nsplit):
        raise ValueError(
            f"decode plan: {nsplit} splits of {split_tok} tokens over a "
            f"{width}-token table of {ps}-token pages; the kernels take "
            f"whole pages a split and at most {DECODE_MAX_SPLITS} splits")
    if split_tok // ps * 4 + decode_static_smem(hd) > MAX_SMEM_BYTES:
        raise ValueError(f"decode plan: {split_tok // ps} table entries a "
                         f"CTA do not fit its shared memory at hd {hd}")
    return DecodePlan(split_tok, nsplit, split_tok // ps)


def decode_entry(p: DecodePlan) -> dict:
    """A split's tunable fields: what an ``autotune`` cache entry holds."""
    return {"split_tok": p.split_tok, "nsplit": p.nsplit}


def decode_candidates(M, K, N, G=0, dtype="") -> list:
    """The tuner's search space for a table K tokens wide of G-token pages:
    the rule's split first, then the fewest whole pages a split for each
    nsplit of 1 to DECODE_MAX_SPLITS, each distinct nsplit once."""
    width, ps = K, G
    out = [decode_entry(decode_plan(width, ps))]
    for n in range(1, DECODE_MAX_SPLITS + 1):
        split_tok = -(-(-(-width // n)) // ps) * ps
        e = {"split_tok": split_tok, "nsplit": -(-width // split_tok)}
        if e["nsplit"] not in [c["nsplit"] for c in out]:
            out.append(e)
    return out


#: the pools' dtype names in a decode key
POOL_NAMES = {torch.bfloat16: "bfloat16", torch.int8: "int8",
              torch.uint8: "uint8"}


def _decode_check(entry, M, K, N, G, dtype) -> DecodePlan:
    if dtype not in POOL_NAMES.values() or not isinstance(M, int) or M < 1:
        raise ValueError(f"decode plan: {M} KV heads, {dtype} pool")
    return decode_plan_from(entry, K, G, N)


DECODE_TUNING = autotune.Tuning(
    check=_decode_check, candidates=decode_candidates,
    rule=lambda M, K, N, G, dtype: decode_entry(decode_plan(K, G)))


def decode_plan_for(tbl: torch.Tensor, k_pool: torch.Tensor,
                    plan: dict = None) -> DecodePlan:
    """The split of a launch over block table `tbl` [rows, pps] and pools
    ``[P, ps, KV, hd]`` (int4: ``hd // 2`` bytes): both decode wrappers
    call it.  `plan` where the caller gives one (the tuner's candidates),
    else the tuned ``"attn.paged_decode"`` entry for the table's width,
    ps, KV, hd and the pool's dtype where the cache holds one (never keyed
    by the rows, so a decode-only ragged pack and the paged batch it packs
    split alike), else `decode_plan`.  An entry the kernels cannot take
    raises ValueError, before any launch."""
    _, ps, KV, w = k_pool.shape
    width = tbl.shape[1] * ps
    hd = 2 * w if k_pool.dtype == torch.uint8 else w
    if plan is not None:
        return decode_plan_from(plan, width, ps, hd)
    p = autotune.tuned_plan("attn.paged_decode", KV, width, hd,
                            POOL_NAMES.get(k_pool.dtype, ""), ps,
                            decode_plan_from, width, ps, hd)
    return decode_plan(width, ps) if p is None else p


def _bind_decode(lib: ctypes.CDLL) -> None:
    lib.paged_decode_launch.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.paged_decode_launch.restype = ctypes.c_int
    lib.decode_floor_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.decode_floor_launch.restype = ctypes.c_int


def _check_cuda(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    if not dev.type == "cuda":
        raise ValueError(f"{name}: operands must be CUDA tensors")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != dt:
            raise TypeError(f"{name}: got {t.dtype}, want {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


#: head dim -> the most query heads a KV head the decode kernels are built
#: for (``csrc/decode_common.cuh`` HD_SMALL / MAXG_SMALL, HD_LARGE /
#: MAXG_LARGE, ``shape_ok``)
DECODE_MAX_GROUP = {64: 8, 128: 9}
#: pool dtype -> the kernels' pool kind (``csrc/decode_common.cuh``)
POOL_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}


def check_pools(name: str, q, k_pool, v_pool, k_scale, v_scale) -> int:
    """Validate the K/V pools (and scales) a decode kernel reads for
    queries q [rows, H, hd] bf16, and return the pool kind: bf16
    ``[P, ps, KV, hd]``, int8 the same shape, or int4 ``[P, ps, KV, hd // 2]``
    uint8, the quantized ones with f32 scales ``[P, ps, KV, 1]``; the pools
    16-byte aligned (the kernels read them by 16-byte loads).  Raises on
    anything else, and on shapes the kernels are not built for
    (`DECODE_MAX_GROUP`: head dim 64 with G <= 8, head dim 128 with
    G <= 9)."""
    kind = POOL_KINDS.get(k_pool.dtype)
    if kind is None:
        raise TypeError(f"{name}: no kernel for {k_pool.dtype} pools")
    quant = kind != 0
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: scales go with int8/int4 pools only, "
                         "both or neither")
    _, H, hd = q.shape
    P, ps, KV = k_pool.shape[:3]
    width = hd // 2 if kind == 2 else hd
    if (k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != width or H % KV or (quant and (
                k_scale.shape != (P, ps, KV, 1)
                or v_scale.shape != k_scale.shape))):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)} "
            f"{k_pool.dtype}, scales "
            f"{None if k_scale is None else tuple(k_scale.shape)}")
    if DECODE_MAX_GROUP.get(hd, 0) < H // KV:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} over {KV} KV heads: head dim {hd} "
            f"with {H // KV} query heads per KV head is not built (built: "
            + ", ".join(f"head dim {d} with up to {g}"
                        for d, g in DECODE_MAX_GROUP.items()) + ")")
    tensors = (q, k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
    _check_cuda(name, tensors, (torch.bfloat16, k_pool.dtype, k_pool.dtype,
                                torch.float32, torch.float32))
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must be 16-byte aligned")
    return kind


def paged_decode_attention_cuda(q, k_pool, v_pool, tbl, last_pos,
                                k_scale=None, v_scale=None, window: int = 0,
                                *, plan: dict = None) -> torch.Tensor:
    """Launch the paged decode kernel: q [B, H, hd] bf16; pools as
    `check_pools` takes them; tbl [B, pps] int32; last_pos [B] int32; split
    by `decode_plan_for` (`plan`: a split entry to take in place of the
    cache's and the rule's)."""
    name = "paged_decode_attention_cuda"
    kind = check_pools(name, q, k_pool, v_pool, k_scale, v_scale)
    _check_cuda(name, (q, tbl, last_pos),
                (torch.bfloat16, torch.int32, torch.int32))
    B, H, hd = q.shape
    P, ps, KV = k_pool.shape[:3]
    pps = tbl.shape[1]
    if tbl.dim() != 2 or tbl.shape[0] != B or last_pos.shape != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, tbl "
                         f"{tuple(tbl.shape)}, last_pos "
                         f"{tuple(last_pos.shape)}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    split = decode_plan_for(tbl, k_pool, plan)
    lib = _build.load("paged_decode", _bind_decode)
    code = lib.paged_decode_launch(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(tbl),
        _build.ptr(last_pos), _build.ptr(out),
        B, H, KV, hd, P, ps, pps, int(window), kind, 1.0 / math.sqrt(hd),
        split.split_tok, split.nsplit, _build.stream_of(q))
    _build.check(lib, code, "paged_decode_attention")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


def decode_floor_cuda(rows: int, KV: int, ps: int, pps: int,
                      device) -> None:
    """Launch an empty kernel on the grid, cluster and shared memory that a
    decode launch (paged or ragged) of `rows` rows over a table of pps pages
    of ps tokens takes: the floor of a call, for measurement only (not
    counted as a launch)."""
    if min(rows, KV, ps, pps) < 1 or torch.device(device).type != "cuda":
        raise ValueError(f"decode_floor_cuda: rows {rows}, KV {KV}, page "
                         f"size {ps}, pages {pps} on {device}")
    lib = _build.load("paged_decode", _bind_decode)
    code = lib.decode_floor_launch(
        rows, KV, ps, pps,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(lib, code, "decode floor")


# ------------------------------------------------------- prefill (flash) ----
def flash_prefill_plain(q, k, v, q_positions, k_positions, window: int = 0,
                        bk: int = 128) -> torch.Tensor:
    """Plain version (``flash_prefill_xla``): a loop over kv tiles with the
    online-softmax carry; scores exist as [B, KV, G, Sq, bk] tiles."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cd = q.dtype
    bk = min(bk, max(8, k.shape[1]))

    pad = (-k.shape[1]) % bk
    k_positions = k_positions.to(torch.int32)
    if pad:
        zeros = torch.zeros((B, pad) + tuple(k.shape[2:]), dtype=k.dtype,
                            device=k.device)
        k = torch.cat([k, zeros], dim=1)
        v = torch.cat([v, zeros.to(v.dtype)], dim=1)
        k_positions = torch.cat(
            [k_positions, torch.full((B, pad), -1, dtype=torch.int32,
                                     device=k.device)], dim=1)
    nk = k.shape[1] // bk
    qg = q.reshape(B, Sq, KV, G, hd)
    qpos = q_positions.to(torch.int32)

    m = torch.full((B, KV, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kb = k[:, j * bk:(j + 1) * bk]
        vb = v[:, j * bk:(j + 1) * bk]
        kposb = k_positions[:, j * bk:(j + 1) * bk]
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kb.to(cd))
        s = _round_scores(s, cd) * scale
        mask = (qpos[:, :, None] >= kposb[:, None, :]) \
            & (kposb[:, None, :] >= 0)
        if window:
            mask &= (qpos[:, :, None] - kposb[:, None, :]) < window
        mask = mask[:, None, None]                     # [B, 1, 1, Sq, bk]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgqt,btkh->bkgqh", p, vb.to(torch.float32))
        acc = alpha * acc + pv
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)             # [B, KV, G, Sq, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


#: the CTAs a launch aims at: one per SM of an H100 (132 SMs)
FLASH_TARGET_CTAS = 132
#: (query, head) rows a CTA may take, 16 a row tile, largest first
FLASH_ROWS = (128, 64, 32, 16)
#: warps sharing a row tile, each taking FLASH_BK / key_split keys of a
#: K/V tile (csrc/flash_prefill.cu instantiates these)
FLASH_KEY_SPLITS = (1, 2, 4)
#: warps a CTA may hold (csrc/flash_prefill.cu MAX_WARPS)
FLASH_MAX_WARPS = 8
#: keys per K/V tile and tiles in the shared-memory ring
#: (csrc/flash_prefill.cu BK, STAGES)
FLASH_BK = 64
FLASH_STAGES = 2
#: the head dims the kernel is instantiated for
FLASH_HEAD_DIMS = (64, 128, 256)
#: head dims past this read each QK k-step's Q fragment from shared memory
#: and take one key split, FLASH_WIDE_KEY_SPLIT (16 keys a warp): their
#: output accumulators fill the registers (csrc/flash_prefill.cu
#: q_in_registers)
FLASH_Q_REGS_MAX_HD = 128
FLASH_WIDE_KEY_SPLIT = 4
#: dynamic shared memory a block may use on an H100
MAX_SMEM_BYTES = 232_448


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one flash prefill launch is cut: grid (row tiles, KV, B), each
    CTA taking `rows` consecutive (query, head) rows of one KV head, each
    16-row tile shared by `key_split` warps that take 64 / key_split keys
    of every K/V tile apiece."""
    rows: int       # (query, head) rows per CTA: 16 a row tile
    key_split: int  # warps a row tile
    keys: int       # keys per K/V tile
    warps: int      # rows / 16 * key_split
    grid: tuple     # (ceil(G * Sq / rows), KV, B)
    ctas: int
    kv_tiles: int   # K/V tiles over Skv (a CTA walks those it can see)
    smem: int       # dynamic shared-memory bytes a CTA


def flash_smem(hd: int, rows: int, warps: int) -> int:
    """A CTA's dynamic shared memory (csrc/flash_prefill.cu Smem::bytes):
    the FLASH_STAGES-deep K and V rings of FLASH_BK rows of hd + 8 bf16,
    their positions and the CTA's Q tile; or, if larger, the merge's
    partials (16 rows of hd + 8 f32, a row max and a row sum, a warp)."""
    ld = hd + 8
    tiles = FLASH_STAGES * (2 * FLASH_BK * ld * 2 + FLASH_BK * 4) \
        + rows * ld * 2
    return max(tiles, warps * 16 * (ld * 4 + 8))


@functools.lru_cache(maxsize=None)
def flash_plan(B: int, Sq: int, Skv: int, H: int, KV: int,
               hd: int) -> FlashPlan:
    """The plan for q [B, Sq, H, hd] over k/v [B, Skv, KV, hd], from shape
    alone.  Each KV head has G * Sq rows (G = H / KV), query-major; a CTA
    takes the largest row tile of FLASH_ROWS whose grid still holds
    FLASH_TARGET_CTAS CTAs (larger tiles share each staged K/V tile among
    more rows), else the smallest, 16 rows (the most CTAs, since the kernel
    is bound by each warp's latency, not by the card's rates).  Each 16-row
    tile is shared by key_split warps, each taking hd / 4 keys of every K/V
    tile: 16 at hd 64, 32 at hd 128 (more warps a tile shorten each warp's
    chain of MMAs and exponentials; an hd 128 warp holds twice the
    accumulators, 170 to 220 registers, so half as many fit an SM, and four
    a tile would run qwen3-4b's 256-token grid in two waves); the split is
    halved until the CTA holds at most FLASH_MAX_WARPS warps.

    At hd 256 a warp takes 16 keys (FLASH_WIDE_KEY_SPLIT; its scores must
    fit beside 128 output registers), so a CTA holds 16 or 32 rows, and
    the K/V ring (132.5 KB) leaves room for one CTA an SM: the rows are
    16 while that grid fits in one wave of FLASH_TARGET_CTAS, else 32,
    which halves the waves (recurrentgemma-9b's 256-token prompt: 128
    CTAs of 8 warps, one wave)."""
    if B < 1 or Sq < 1 or KV < 1 or H % KV or hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_plan: B = {B}, Sq = {Sq}, H = {H}, "
                         f"KV = {KV}, hd = {hd}")
    R = H // KV * Sq
    if hd > FLASH_Q_REGS_MAX_HD:
        key_split = FLASH_WIDE_KEY_SPLIT
        rows = 16 if -(-R // 16) * KV * B <= FLASH_TARGET_CTAS \
            else FLASH_MAX_WARPS // key_split * 16
    else:
        rows = FLASH_ROWS[-1]
        for r in FLASH_ROWS:
            if -(-R // r) * KV * B >= FLASH_TARGET_CTAS:
                rows = r
                break
        key_split = FLASH_BK // (hd // 4)
        while rows // 16 * key_split > FLASH_MAX_WARPS:
            key_split //= 2
    return _flash_cut(B, Sq, Skv, H, KV, hd, rows, key_split)


def _flash_cut(B, Sq, Skv, H, KV, hd, rows, key_split) -> FlashPlan:
    warps = rows // 16 * key_split
    grid = (-(-(H // KV * Sq) // rows), KV, B)
    return FlashPlan(rows, key_split, FLASH_BK, warps, grid,
                     grid[0] * KV * B, -(-Skv // FLASH_BK),
                     flash_smem(hd, rows, warps))


def flash_plan_from(entry: dict, B: int, Sq: int, Skv: int, H: int,
                    KV: int, hd: int) -> FlashPlan:
    """The plan of a tuned entry ({rows, key_split}) for the launch's full
    shape; ValueError unless the kernel takes it there: rows of
    FLASH_ROWS, a key split of FLASH_KEY_SPLITS (only FLASH_WIDE_KEY_SPLIT
    past FLASH_Q_REGS_MAX_HD), at most FLASH_MAX_WARPS warps, and its
    shared memory within MAX_SMEM_BYTES."""
    rows, key_split = (autotune.int_field(entry, k)
                       for k in ("rows", "key_split"))
    if B < 1 or Sq < 1 or KV < 1 or H % KV or hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash plan: B = {B}, Sq = {Sq}, H = {H}, "
                         f"KV = {KV}, hd = {hd}")
    if rows not in FLASH_ROWS or key_split not in FLASH_KEY_SPLITS or (
            hd > FLASH_Q_REGS_MAX_HD and key_split != FLASH_WIDE_KEY_SPLIT):
        raise ValueError(f"flash plan: {rows} rows, key split {key_split} "
                         f"at hd {hd}; the kernel takes rows {FLASH_ROWS} "
                         f"and key splits {FLASH_KEY_SPLITS} (only "
                         f"{FLASH_WIDE_KEY_SPLIT} past hd "
                         f"{FLASH_Q_REGS_MAX_HD})")
    warps = rows // 16 * key_split
    if warps > FLASH_MAX_WARPS or flash_smem(hd, rows, warps) \
            > MAX_SMEM_BYTES:
        raise ValueError(f"flash plan: {warps} warps of {rows} rows at hd "
                         f"{hd}: at most {FLASH_MAX_WARPS} warps and "
                         f"{MAX_SMEM_BYTES} bytes of shared memory a CTA")
    return _flash_cut(B, Sq, Skv, H, KV, hd, rows, key_split)


def flash_entry(p: FlashPlan) -> dict:
    """A plan's tunable fields: what an ``autotune`` cache entry holds."""
    return {"rows": p.rows, "key_split": p.key_split}


def _flash_shape(M, K, N, G):
    """(B, Sq, Skv, H, KV, hd) of an ``"attn.prefill"`` key's shape."""
    if not (isinstance(M, tuple) and isinstance(N, tuple) and len(M) == 2
            and len(N) == 2):
        raise ValueError(f"flash plan: key shape m{M} n{N}; want (B, Sq) "
                         "and (H, hd)")
    return M[0], M[1], K, N[0], G, N[1]


def flash_candidates(M, K, N, G=0, dtype="") -> list:
    """The tuner's search space at this shape: the rule's plan first, then
    every (rows, key_split) the kernel takes there."""
    shape = _flash_shape(M, K, N, G)
    out = [flash_entry(flash_plan(*shape))]
    splits = (FLASH_WIDE_KEY_SPLIT,) if shape[5] > FLASH_Q_REGS_MAX_HD \
        else FLASH_KEY_SPLITS
    for key_split in splits:
        for rows in FLASH_ROWS:
            e = {"rows": rows, "key_split": key_split}
            if e in out:
                continue
            try:
                flash_plan_from(e, *shape)
            except ValueError:
                continue
            out.append(e)
    return out


def _flash_check(entry, M, K, N, G, dtype) -> FlashPlan:
    if dtype != "bfloat16":
        raise ValueError(f"flash plan: {dtype} operands; the kernel takes "
                         "bfloat16")
    return flash_plan_from(entry, *_flash_shape(M, K, N, G))


FLASH_TUNING = autotune.Tuning(
    check=_flash_check, candidates=flash_candidates,
    rule=lambda M, K, N, G, dtype: flash_entry(
        flash_plan(*_flash_shape(M, K, N, G))))


def flash_launch_plan(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int,
                      plan: dict = None) -> FlashPlan:
    """The plan a flash launch takes: `plan` where the caller gives one
    (the tuner's candidates), else the tuned ``"attn.prefill"`` entry for
    the launch's whole shape where the cache holds one, else `flash_plan`.
    An entry the kernel cannot take raises ValueError, before any
    launch."""
    if plan is not None:
        return flash_plan_from(plan, B, Sq, Skv, H, KV, hd)
    p = autotune.tuned_plan("attn.prefill", (B, Sq), Skv, (H, hd),
                            "bfloat16", KV, flash_plan_from, B, Sq, Skv, H,
                            KV, hd)
    return flash_plan(B, Sq, Skv, H, KV, hd) if p is None else p


def _bind_flash(lib: ctypes.CDLL) -> None:
    lib.flash_prefill_launch.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.flash_prefill_launch.restype = ctypes.c_int


def flash_prefill_cuda(q, k, v, q_positions, k_positions, window: int = 0,
                       *, plan: dict = None) -> torch.Tensor:
    """Launch the flash prefill kernel: q [B, Sq, H, hd] bf16, k/v
    [B, Skv, KV, hd] bf16 (hd 64, 128 or 256, 16-byte aligned), positions
    [B, S] int32 (-1 = padding); cut by `flash_launch_plan` (`plan`: a
    plan entry to take in place of the cache's and the rule's)."""
    bf, i32 = torch.bfloat16, torch.int32
    _check_cuda("flash_prefill_cuda", (q, k, v, q_positions, k_positions),
                (bf, bf, bf, i32, i32))
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd or H % KV
            or q_positions.shape != (B, Sq) or k_positions.shape != (B, Skv)):
        raise ValueError(
            f"flash_prefill_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"positions {tuple(q_positions.shape)} / "
            f"{tuple(k_positions.shape)}")
    if hd not in FLASH_HEAD_DIMS or KV > 65535 or B > 65535 or any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            f"flash_prefill_cuda: head dim {hd}, KV = {KV}, B = {B}: the "
            f"kernel is latency-bound and built for head dims "
            f"{FLASH_HEAD_DIMS} only (its QK and PV fragments, bf16 "
            "mma.sync, live in registers sized by the head dim), reads "
            "q/k/v by 16-byte cp.async (so 16-byte aligned), and puts KV "
            "and B on the grid's y and z (<= 65535)")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    cut = flash_launch_plan(B, Sq, Skv, H, KV, hd, plan)
    lib = _build.load("flash_prefill", _bind_flash)
    code = lib.flash_prefill_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(q_positions),
        _build.ptr(k_positions), _build.ptr(out), B, Sq, Skv, H, KV, hd,
        int(window), 1.0 / math.sqrt(hd), cut.warps, cut.key_split,
        _build.stream_of(q))
    _build.check(lib, code, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0
