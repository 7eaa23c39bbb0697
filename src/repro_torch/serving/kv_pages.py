"""Paged KV cache: fixed-size pages from a preallocated pool + block tables
(PyTorch port of ``repro/serving/kv_pages.py``).

Device side, each attention layer's cache is a dict

    {"tbl": [B, pages_per_seq] int32,        # logical page -> physical page
     "k":   [num_pages, page_size, KV, hd],  # shared pool
     "v":   [num_pages, page_size, KV, hd],
     (+ "k_scale"/"v_scale" [num_pages, page_size, KV, 1] f32 for int8
      pools, and for int4 pools, whose K/V are [..., hd // 2] uint8 nibble
      pairs),
     (+ "slots" [T] int32 on the ragged step: the table row of each packed
      token row, -1 = padding; "tbl" is then the whole table pool)}

and the model tree stacks the pools of all layers: ``caches["rep"]["u0"]
["attn"]["k"]`` is ``[n_layers, num_pages, page_size, KV, hd]``.  Logical
slot ``j`` of a sequence lives at ``tbl[j // page_size]``, slot
``j % page_size``.  Unallocated table slots hold the sentinel
``num_pages``.  Quantized pools store `models.attention.quantize_kv`'s
bytes and read back through `dequantize_kv`, as the JAX package's do.

The JAX package routes writes through that sentinel out of bounds, where
``mode="drop"`` discards them, and reads it with ``mode="fill"`` zeros.
PyTorch has neither, so both are explicit here:

  * every pool (scale pools too) is allocated with one spill page behind
    its last page (``alloc_pool``): the pool tensor is the first
    ``num_pages`` pages of that storage, and the writes send every row
    whose position (or ragged slot) is negative, or whose table entry is
    the sentinel, to the spill page.  A write is one ``index_copy_`` per
    pool with no host sync; the spill page is never read.
  * ``paged_read`` gathers through clamped indices and then replaces every
    sentinel slot by exact zeros.

Pools are updated in place: the writes return the same tensors they were
given (where the JAX package returns new, donated buffers).

The contiguous layout (``ServingConfig.layout="contiguous"``) keeps one
max_ctx row per batch slot (``models.transformer.init_caches``);
`gather_rows` and `scatter_rows` move whole rows between the engine's
cache tree and a step's batch, and ``ContinuousKVCache`` stands behind the
page manager's interface for it.

Host side, ``PagedKVCacheManager`` owns the page pool and per-request page
lists, with refcounted, content-addressed prefix caching: full pages are
identified by a chained hash of the tokens behind them, admission shares
the longest cached page-aligned prefix (refcount + 1, never rewritten), and
refcount-0 registered pages park in an LRU until the blank list runs dry.
Its bookkeeping round-trips through ``state`` / ``load_state`` (engine
snapshots), and ``fail_next_admits`` makes the next admissions report a
capacity miss (the chaos harness).  It is numpy and Python only and ports
verbatim.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.attention import dequantize_kv, quantize_kv
from ..observability.metrics import NULL_REGISTRY

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_QUANT = ("int8", "int4")


# ------------------------------------------------------- device-side cache --
def alloc_pool(shape, dtype, device) -> torch.Tensor:
    """Zeroed pool ``shape`` = [..., P, ps, KV, hd] whose storage holds one
    more page (the spill page of the writes) behind each pool."""
    shape = tuple(shape)
    store = torch.zeros(shape[:-4] + (shape[-4] + 1,) + shape[-3:],
                        dtype=dtype, device=device)
    return store.narrow(-4, 0, shape[-4])


def _with_spill_page(pool: torch.Tensor) -> torch.Tensor:
    """The [P + 1, ps, KV, hd] view of a pool from ``alloc_pool``."""
    P = pool.shape[0]
    return pool.as_strided((P + 1,) + tuple(pool.shape[1:]), pool.stride(),
                           pool.storage_offset())


def init_paged_caches(cfg, rt, sv, device="cuda") -> Dict:
    """Full-model paged pools, stacked over layers:
    ``{"rep": {"u0": {"attn": {"k", "v"(, "k_scale", "v_scale")}}},
    "tail": {}}``.  Block tables are bound per step with
    ``with_block_tables`` (or ``with_token_slots``)."""
    blocks = tuple(cfg.pattern) + tuple(cfg.tail)
    if blocks != ("A",):
        raise NotImplementedError(
            f"paged KV serving of block pattern {blocks} is not ported")
    if rt.cache_dtype not in _DTYPES and rt.cache_dtype not in _QUANT:
        raise ValueError(f"cache_dtype={rt.cache_dtype!r}")
    lead = (cfg.n_repeats, sv.num_pages, sv.page_size, cfg.n_kv_heads)
    if rt.cache_dtype in _QUANT:
        int4 = rt.cache_dtype == "int4"
        shape = lead + (cfg.hd // 2 if int4 else cfg.hd,)
        dt = torch.uint8 if int4 else torch.int8
        attn = {"k_scale": alloc_pool(lead + (1,), torch.float32, device),
                "v_scale": alloc_pool(lead + (1,), torch.float32, device)}
    else:
        shape, dt, attn = lead + (cfg.hd,), _DTYPES[rt.cache_dtype], {}
    attn.update(k=alloc_pool(shape, dt, device),
                v=alloc_pool(shape, dt, device))
    return {"rep": {"u0": {"attn": attn}}, "tail": {}}


def _write_rows(cache: Dict, k, v, idx) -> None:
    """Store K/V rows [N, KV, hd] (k, v flattened over their leading dims)
    at flat pool slots ``idx`` [N] (the spill page's slots included),
    quantizing them first when the pool carries scales."""
    P, ps = cache["k"].shape[:2]

    def write(pool, val):
        flat = _with_spill_page(pool).view((P + 1) * ps, *pool.shape[2:])
        flat.index_copy_(0, idx, val.reshape(-1, *pool.shape[2:]).to(
            pool.dtype))

    for name, val in (("k", k), ("v", v)):
        if name + "_scale" in cache:
            val, scale = quantize_kv(val, cache[name].dtype == torch.uint8)
            write(cache[name + "_scale"], scale)
        write(cache[name], val)


def paged_write(cache: Dict, k, v, abs_pos) -> Dict:
    """Write k/v [B, n, KV, hd] at absolute positions abs_pos [B, n] through
    the block table, in place.  Negative positions (left padding, inactive
    rows) and sentinel table entries land on the spill page."""
    P, ps = cache["k"].shape[:2]
    tbl = cache["tbl"]
    logical = torch.clamp(abs_pos // ps, 0, tbl.shape[1] - 1).long()
    phys = torch.gather(tbl, 1, logical).long()
    page = torch.where(abs_pos >= 0, phys, P)
    _write_rows(cache, k, v, (page * ps + abs_pos % ps).reshape(-1))
    return cache


def ragged_paged_write(cache: Dict, k, v, abs_pos) -> Dict:
    """Token-major twin of ``paged_write``: k/v [1, T, KV, hd] packed rows,
    each routed through the table row its token belongs to
    (``cache["slots"]`` [T], bound by ``with_token_slots``) at absolute
    position ``abs_pos`` [1, T].  Padding rows (slot or position -1) and
    sentinel table entries land on the spill page.  Quantization is per
    token, the same `quantize_kv` as the bucketed writes, so a pool filled
    by ragged steps holds the bytes bucketed prefill + decode would."""
    P, ps = cache["k"].shape[:2]
    tbl, slots = cache["tbl"], cache["slots"].long()
    pos = abs_pos.reshape(-1)
    logical = torch.clamp(pos // ps, 0, tbl.shape[1] - 1).long()
    phys = tbl[torch.clamp(slots, 0, tbl.shape[0] - 1), logical].long()
    page = torch.where((pos >= 0) & (slots >= 0), phys, P)
    _write_rows(cache, k, v, page * ps + pos % ps)
    return cache


def paged_read(cache: Dict, last_pos):
    """Gather each row's pages back into the contiguous [B, max_ctx, KV, hd]
    layout (dequantized to bf16 when the pool is quantized).  last_pos [B]
    is the newest valid position per row (-1 = inactive); returns
    (k, v, kpos) with kpos[b, j] = j for valid slots and -1 otherwise.
    Sentinel table slots read as exact zeros, so stale pool data behind a
    dead entry never reaches attention."""
    P, ps = cache["k"].shape[:2]
    tbl = cache["tbl"].long()
    B, pps = tbl.shape
    max_ctx = pps * ps
    idx = (tbl[:, :, None] * ps + torch.arange(ps, device=tbl.device)
           ).reshape(B, max_ctx)
    dead = idx >= P * ps
    safe = torch.where(dead, 0, idx)

    def gather(pool):
        flat = pool.reshape(P * ps, *pool.shape[2:])
        g = flat[safe]
        return torch.where(dead[:, :, None, None], torch.zeros_like(g), g)

    if "k_scale" in cache:
        k = dequantize_kv(gather(cache["k"]), gather(cache["k_scale"]))
        v = dequantize_kv(gather(cache["v"]), gather(cache["v_scale"]))
    else:
        k, v = gather(cache["k"]), gather(cache["v"])
    j = torch.arange(max_ctx, dtype=torch.int32, device=tbl.device)[None, :]
    lp = last_pos.to(torch.int32)[:, None]
    valid = (j <= lp) & (lp >= 0)
    return k, v, torch.where(valid, j, -1).to(torch.int32)


def _bind(caches: Dict, leaves: Dict) -> Dict:
    """Rebind `leaves` into every attention cache (a dict holding "k");
    pools pass through untouched, stale routing leaves are dropped."""
    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key not in ("tbl", "slots"):
                out[key] = val
        if "k" in node:
            out.update(leaves)
        return out

    return {"rep": walk(caches["rep"]), "tail": walk(caches["tail"])}


def gather_rows(caches: Dict, rows: torch.Tensor) -> Dict:
    """New tensors holding batch rows `rows` [n] (int64) of a contiguous
    cache tree: rep leaves carry the batch at dim 1 under the repeat
    stacking, tail leaves at dim 0."""
    def walk(node, dim):
        return {k: walk(v, dim) if isinstance(v, dict)
                else v.index_select(dim, rows) for k, v in node.items()}

    return {"rep": walk(caches["rep"], 1), "tail": walk(caches["tail"], 0)}


def scatter_rows(caches: Dict, sub: Dict, rows: torch.Tensor) -> Dict:
    """Write a gathered or fresh sub-cache tree `sub` into batch rows
    `rows` [n] (int64, distinct) of the contiguous cache tree `caches`, in
    place (``index_copy_``; the JAX package returns new buffers), and
    return `caches`.  Rows not named are untouched."""
    def walk(dst, src, dim):
        for k, v in dst.items():
            if isinstance(v, dict):
                walk(v, src[k], dim)
            else:
                v.index_copy_(dim, rows, src[k].to(v.dtype))

    walk(caches["rep"], sub["rep"], 1)
    walk(caches["tail"], sub["tail"], 0)
    return caches


def with_block_tables(caches: Dict, tbl) -> Dict:
    """Bind the block table `tbl` [B, pages_per_seq] to every attention
    cache (the same positions are cached in every layer, so one table
    serves all)."""
    return _bind(caches, {"tbl": tbl})


def with_token_slots(caches: Dict, tbl, slots) -> Dict:
    """Bind the ragged step's routing to every attention cache: the whole
    table pool `tbl` [max_batch, pages_per_seq] and the per-token table row
    `slots` [T] (-1 = padding row).  The "slots" leaf is what sends
    ``models.attention.apply_attention`` down the ragged branch."""
    return _bind(caches, {"tbl": tbl, "slots": slots})


# --------------------------------------------------------- host-side manager --
_HASH_SEED = 0x9E3779B97F4A7C15


def _chain_hash(prev: int, tokens: np.ndarray) -> int:
    """Chained block hash: pins the whole prefix behind a page."""
    return hash((prev, np.asarray(tokens, np.int32).tobytes()))


class PagedKVCacheManager:
    """Refcounted, content-addressed page pool + per-request block tables.

    Every page is in exactly one of three states: blank (free, contents
    meaningless), warm (refcount 0 but still registered in the prefix
    index, LRU-evictable) or in use (refcount >= 1)."""

    def __init__(self, sv, metrics=None):
        self.sv = sv
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.blank: deque = deque(range(sv.num_pages))
        self.warm: "OrderedDict[int, None]" = OrderedDict()
        self.pages: Dict[int, List[int]] = {}
        self.refcount: Dict[int, int] = {}
        self.index: Dict[int, int] = {}        # chain hash -> page
        self.page_hash: Dict[int, int] = {}    # page -> chain hash
        self._chain: Dict[int, Tuple[int, int]] = {}  # rid -> (pages hashed, h)
        self.high_water = 0
        self.n_lookups = 0
        self.n_hit_tokens = 0
        self.n_evictions = 0
        # chaos hook (serving/chaos.py): the next N admissions that would
        # allocate pages report capacity failure instead, exercising the
        # all-or-nothing admission path without real pool pressure
        self.fail_next_admits = 0

    # -- capacity ---------------------------------------------------------
    @property
    def free(self) -> List[int]:
        return list(self.blank) + list(self.warm)

    @property
    def available(self) -> int:
        return len(self.blank) + len(self.warm)

    @property
    def in_use(self) -> int:
        return self.sv.num_pages - self.available

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.sv.page_size)

    def fits_alone(self, n_tokens: int) -> bool:
        return (self.pages_for(n_tokens) <= self.sv.num_pages
                and n_tokens <= self.sv.max_ctx)

    def capacity_desc(self) -> str:
        return (f"max_ctx={self.sv.max_ctx}, pool={self.sv.num_pages} pages "
                f"of {self.sv.page_size} tokens")

    # -- allocation -------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        if self.blank:
            return self.blank.popleft()
        if self.warm:
            page, _ = self.warm.popitem(last=False)      # LRU-oldest
            h = self.page_hash.pop(page)
            del self.index[h]
            self.n_evictions += 1
            self.metrics.counter("prefix_evictions_total",
                                 "warm pages evicted to blank").inc()
            return page
        return None

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow rid's allocation to cover n_tokens cached slots
        (all-or-nothing; new pages are private)."""
        if n_tokens > self.sv.max_ctx:
            return False
        have = self.pages.setdefault(rid, [])
        need = self.pages_for(n_tokens) - len(have)
        if need > self.available:
            return False
        for _ in range(need):
            page = self._alloc_page()
            self.refcount[page] = 1
            have.append(page)
        self.high_water = max(self.high_water, self.in_use)
        return True

    def release(self, rid: int) -> None:
        """Drop rid's hold on its pages; registered refcount-0 pages stay
        warm (with prefix_lru), the rest go blank."""
        for p in self.pages.pop(rid, []):
            self.refcount[p] -= 1
            if self.refcount[p]:
                continue
            del self.refcount[p]
            if p in self.page_hash and self.sv.prefix_lru:
                self.warm[p] = None
                self.warm.move_to_end(p)
            else:
                h = self.page_hash.pop(p, None)
                if h is not None:
                    del self.index[h]
                self.blank.append(p)
        self._chain.pop(rid, None)

    # -- prefix cache ------------------------------------------------------
    def _match(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix, capped below len(tokens) so the caller
        always recomputes at least the final token."""
        ps = self.sv.page_size
        max_full = max(len(tokens) - 1, 0) // ps
        h = _HASH_SEED
        shared: List[int] = []
        for i in range(max_full):
            h_next = _chain_hash(h, tokens[i * ps:(i + 1) * ps])
            page = self.index.get(h_next)
            if page is None:
                break
            shared.append(page)
            h = h_next
        return shared, h

    def admit_request(self, rid: int, tokens: np.ndarray,
                      n_tokens: int) -> Optional[int]:
        """All-or-nothing admission: share the matched prefix pages and
        allocate private pages for the rest of `n_tokens`.  Returns the hit
        length in tokens, or None (and changes nothing) when it does not
        fit."""
        assert rid not in self.pages, f"rid {rid} already holds pages"
        if n_tokens > self.sv.max_ctx:
            return None
        if self.fail_next_admits:
            # injected allocator failure: exactly a capacity miss (nothing
            # held, nothing counted, the request waits)
            self.fail_next_admits -= 1
            self.metrics.counter(
                "chaos_alloc_failures_total",
                "admissions failed by the chaos allocator hook").inc()
            return None
        shared, h = self._match(tokens) if self.sv.prefix_cache \
            else ([], _HASH_SEED)
        warm_shared = sum(1 for p in shared if not self.refcount.get(p))
        need = self.pages_for(n_tokens) - len(shared)
        if need > self.available - warm_shared:
            return None
        for p in shared:
            if not self.refcount.get(p):
                del self.warm[p]
            self.refcount[p] = self.refcount.get(p, 0) + 1
        have = self.pages[rid] = list(shared)
        for _ in range(max(need, 0)):
            page = self._alloc_page()
            self.refcount[page] = 1
            have.append(page)
        self._chain[rid] = (len(shared), h)
        self.high_water = max(self.high_water, self.in_use)
        if self.sv.prefix_cache:
            self.n_lookups += 1
            self.n_hit_tokens += len(shared) * self.sv.page_size
            self.metrics.counter("prefix_lookups_total",
                                 "admission prefix-cache lookups").inc()
            if shared:
                self.metrics.counter("prefix_hits_total",
                                     "admissions that matched >=1 page").inc()
                self.metrics.counter("prefix_hit_pages_total",
                                     "pages served from the cache").inc(
                                         len(shared))
        return len(shared) * self.sv.page_size

    def register_upto(self, rid: int, tokens: np.ndarray, n_valid: int) -> None:
        """Index every full written page of rid's prefix (idempotent,
        incremental, first writer wins)."""
        if not self.sv.prefix_cache:
            return
        ps = self.sv.page_size
        have = self.pages.get(rid, [])
        done, h = self._chain.get(rid, (0, _HASH_SEED))
        full = min(n_valid // ps, len(have))
        for i in range(done, full):
            h = _chain_hash(h, tokens[i * ps:(i + 1) * ps])
            page = have[i]
            if h not in self.index and page not in self.page_hash:
                self.index[h] = page
                self.page_hash[page] = h
        self._chain[rid] = (full, h)

    # -- block tables ------------------------------------------------------
    def table_row(self, rid: int) -> np.ndarray:
        """Unallocated logical slots carry the sentinel (== num_pages)."""
        row = np.full((self.sv.pages_per_seq,), self.sv.num_pages, np.int32)
        have = self.pages.get(rid, [])
        row[: len(have)] = have
        return row

    # -- invariants --------------------------------------------------------
    def check_invariants(self) -> None:
        """blank / warm / in-use partition the pool; refcounts are >= 1 and
        equal the ownership multiset (so free pages plus ownership shares
        make the pool); only registered pages are shared or warm; the
        prefix index and page_hash are inverse maps.  Shared by the chaos
        harness, which asserts it after every event."""
        blank, warm = set(self.blank), set(self.warm)
        in_use = set(self.refcount)
        assert len(blank) == len(self.blank), "blank list holds duplicates"
        assert not (blank & warm) and not (blank & in_use) \
            and not (warm & in_use), "pool state overlap"
        assert blank | warm | in_use == set(range(self.sv.num_pages)), \
            "pool partition incomplete"
        assert all(c >= 1 for c in self.refcount.values())
        shares = sum(1.0 / self.refcount[p]
                     for pages in self.pages.values() for p in pages)
        assert abs(self.available + shares - self.sv.num_pages) < 1e-9, \
            "ownership shares + free pages != pool"
        owners: Dict[int, int] = {}
        for rid, pages in self.pages.items():
            assert len(set(pages)) == len(pages), \
                f"rid {rid} holds a page twice"
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        assert owners == self.refcount, "refcounts disagree with ownership"
        for p, c in self.refcount.items():
            if c > 1:
                assert p in self.page_hash, f"unsealed page {p} shared"
        assert all(p in self.page_hash for p in warm), \
            "warm page lost its registration"
        assert self.index == {h: p for p, h in self.page_hash.items()}, \
            "index/page_hash out of sync"

    # -- snapshot ----------------------------------------------------------
    def state(self) -> Dict:
        """Host-side allocator state for ``InferenceEngine.snapshot()``.
        The prefix-index keys are Python hashes: stable within a process; a
        snapshot restored in another process keeps its warm-page hits only
        with ``PYTHONHASHSEED`` pinned."""
        return {
            "blank": list(self.blank),
            "warm": list(self.warm),
            "pages": {rid: list(p) for rid, p in self.pages.items()},
            "refcount": dict(self.refcount),
            "index": dict(self.index),
            "page_hash": dict(self.page_hash),
            "chain": dict(self._chain),
            "high_water": self.high_water,
            "n_lookups": self.n_lookups,
            "n_hit_tokens": self.n_hit_tokens,
            "n_evictions": self.n_evictions,
        }

    def load_state(self, st: Dict) -> None:
        self.blank = deque(st["blank"])
        self.warm = OrderedDict((p, None) for p in st["warm"])
        self.pages = {rid: list(p) for rid, p in st["pages"].items()}
        self.refcount = dict(st["refcount"])
        self.index = dict(st["index"])
        self.page_hash = dict(st["page_hash"])
        self._chain = dict(st["chain"])
        self.high_water = st["high_water"]
        self.n_lookups = st["n_lookups"]
        self.n_hit_tokens = st["n_hit_tokens"]
        self.n_evictions = st["n_evictions"]
        self.check_invariants()


class ContinuousKVCache:
    """The contiguous (static-slot) layout behind the page manager's
    interface: each batch slot owns a whole max_ctx cache row, so `ensure`
    only checks the context bound and there is nothing to allocate, share
    or preempt."""

    def __init__(self, sv, metrics=None):
        self.sv = sv
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.high_water = 0
        self.n_lookups = 0
        self.n_hit_tokens = 0
        self.n_evictions = 0

    def fits_alone(self, n_tokens: int) -> bool:
        return n_tokens <= self.sv.max_ctx

    def capacity_desc(self) -> str:
        return f"max_ctx={self.sv.max_ctx}"

    def ensure(self, rid: int, n_tokens: int) -> bool:
        return n_tokens <= self.sv.max_ctx

    def release(self, rid: int) -> None:
        pass

    def admit_request(self, rid: int, tokens, n_tokens: int) -> Optional[int]:
        return 0 if n_tokens <= self.sv.max_ctx else None

    def register_upto(self, rid: int, tokens, n_valid: int) -> None:
        pass

    def check_invariants(self) -> None:
        pass                       # nothing allocated, nothing to violate

    def state(self) -> Dict:
        return {}

    def load_state(self, st: Dict) -> None:
        pass
