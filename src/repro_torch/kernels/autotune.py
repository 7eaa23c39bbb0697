"""Plan autotuner for the GEMM kernels, and the attention ops' default tiles.

Ports ``repro/kernels/autotune.py``.  The JAX package tunes Pallas block
shapes (bm, bn, bk); the port's kernels are cut by plans instead
(``int4_matmul.w4a4_plan``, ``lut4_matmul.lut4_plan``,
``w4a16_matmul.splitk_plan`` / ``prefill_plan``), and an entry of the
cache holds the tunable fields of the op's plan:

  * ``"int4_matmul"`` (both W4A4 entries; the key's dtype tells them apart:
    ``float32`` x for the fused one, ``int8`` a_q for the unfused one):
    ``bm``, ``bn``, ``rows``, ``splits``;
  * ``"gemm.lut4"``: ``bm``, ``rows``, ``splits``;
  * ``"w4a16_matmul"``: ``mt``, ``rows`` at M <= 16 (the split-K plan),
    ``kernel``, ``bm`` above (the prefill plan).

Each kernel module owns what its kernel takes (``TUNING``: an entry's
check, the candidate set, the rule's entry); this module owns the cache
and the search:

  * ``lookup(op, M, K, N, dtype, ...)`` — what every CUDA wrapper asks
    before it cuts a launch: the tuned entry for the shape, else None, and
    the wrapper takes its rule's plan.  The wrappers ask by shape alone; a
    site-tagged entry (``tag=``) is read only by a lookup that names the
    site.  Never searches, and returns at once while the cache is empty.
    The plain versions never ask.
  * ``tune(...)`` — the timed search over an op's candidate plans, run
    explicitly (``chip_smoke.py``'s tune phase on the card); results
    persist to an on-disk JSON cache keyed by (op, shape, dtype, group
    size, backend ``cuda``, tag).

Cache location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json``.  With no cache file every launch
takes its rule's plan.

The attention ops (``attn.paged_decode``, ``attn.ragged``,
``attn.prefill``) are not tuned: their plans are fixed
(``paged_attention.decode_plan`` / ``flash_plan``).  Only their default
tiles are kept here, which the plain versions take their blocking from,
as the JAX package's XLA twins do on an untuned host: the decode twin's
pages per block is ``attn_default_blocks(...)["bk"] // page_size`` and
the flash twin's kv tile is ``attn_default_blocks(...)["bk"]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..observability.metrics import global_registry

ENV_CACHE_PATH = "REPRO_AUTOTUNE_CACHE"
#: the backend field of every key: the JAX package's entries never match
BACKEND = "cuda"
#: the ops the tuner searches, each a GEMM kernel's plan
GEMM_OPS = ("int4_matmul", "gemm.lut4", "w4a16_matmul")

# What a rejected candidate may raise: a plan the kernel cannot take
# (ValueError from the plan checks, before any launch), or an assert of
# make_call's.  A failed launch (RuntimeError from _build.check) is not a
# rejected plan: it can leave the CUDA context unusable, so it propagates,
# as do programming errors (TypeError, ...).
_TILE_REJECT_ERRORS = (ValueError, AssertionError, NotImplementedError)

# in-memory mirror of the on-disk cache: key -> the plan's fields and "us"
_CACHE: Dict[str, Dict] = {}
_LOADED_FROM: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Tuning:
    """What a GEMM kernel's module tells the tuner.  Every callable takes
    the key's shape, group size and dtype name: ``check(entry, M, K, N,
    G, dtype)`` raises ValueError unless the kernel takes the entry there
    (16-byte aligned operands assumed); ``candidates(M, K, N, G, dtype)``
    is the search space, the rule's entry included; ``rule(M, K, N, G,
    dtype)`` is the rule's plan as an entry."""
    check: Callable
    candidates: Callable
    rule: Callable


def tuning(op: str) -> Tuning:
    """The kernel module's `Tuning` for a GEMM op; ValueError for any
    other op (the attention ops keep their fixed plans)."""
    from . import int4_matmul, lut4_matmul, w4a16_matmul

    table = {"int4_matmul": int4_matmul.TUNING,
             "gemm.lut4": lut4_matmul.TUNING,
             "w4a16_matmul": w4a16_matmul.TUNING}
    if op not in table:
        raise ValueError(f"autotune: no plan search for op {op!r}; the "
                         f"tuned ops are {GEMM_OPS}")
    return table[op]


def int_field(entry, name: str, default: int = None) -> int:
    """An entry's integer field; ValueError when it is missing (without a
    default) or not an integer."""
    v = entry.get(name, default) if isinstance(entry, dict) else None
    if not isinstance(v, int) or isinstance(v, bool):
        raise ValueError(f"autotune entry {entry!r}: field {name!r} must be "
                         f"an integer")
    return v


def cache_path() -> str:
    env = os.environ.get(ENV_CACHE_PATH)
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def cache_key(op: str, M: int, K: int, N: int, dtype: str,
              group_size: int = 0, backend: str = "", tag: str = "") -> str:
    backend = backend or BACKEND
    key = f"{op}|m{M}|k{K}|n{N}|{dtype}|g{group_size}|{backend}"
    return f"{key}|{tag}" if tag else key


def _parse_key(key: str):
    """(op, M, K, N, dtype, group size) of a key on this backend, else
    None."""
    parts = key.split("|")
    if len(parts) not in (7, 8) or parts[6] != BACKEND:
        return None
    op, m, k, n, dtype, g = parts[:6]
    try:
        if (m[0], k[0], n[0], g[0]) != ("m", "k", "n", "g"):
            return None
        return op, int(m[1:]), int(k[1:]), int(n[1:]), dtype, int(g[1:])
    except (IndexError, ValueError):
        return None


def _entry_ok(key: str, entry) -> bool:
    """Is ``entry`` a plan the key's kernel takes at the key's shape?"""
    parsed = _parse_key(key)
    if parsed is None or parsed[0] not in GEMM_OPS \
            or not isinstance(entry, dict):
        return False
    op, M, K, N, dtype, G = parsed
    try:
        tuning(op).check(entry, M, K, N, G, dtype)
    except (ValueError, TypeError, KeyError):
        return False
    return True


def reset() -> None:
    """Drop in-memory state (tests; cache file is untouched)."""
    global _LOADED_FROM
    _CACHE.clear()
    _LOADED_FROM = None


def load_cache(path: Optional[str] = None) -> int:
    """Merge the on-disk cache into memory; returns #entries loaded.
    A missing or corrupt file is an empty cache, never an error; an entry
    that is not a plan its kernel takes at its key's shape is skipped."""
    global _LOADED_FROM
    path = path or cache_path()
    _LOADED_FROM = path
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0
    if not isinstance(data, dict):
        return 0
    n = 0
    for key, entry in data.items():
        if _entry_ok(key, entry):
            _CACHE[key] = entry
            n += 1
    return n


def save_cache(path: Optional[str] = None) -> str:
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_CACHE, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def ensure_loaded() -> None:
    if _LOADED_FROM is None:
        load_cache()


# --------------------------------------------------------------- lookup ----
def lookup(op: str, M: int, K: int, N: int, dtype: str,
           group_size: int = 0, tag: str = "") -> Optional[Dict]:
    """The tuned plan entry for this GEMM if cached (site-tagged entry
    first, then the shape-generic one), without its time; else None."""
    ensure_loaded()
    if not _CACHE:                     # untuned: no key built, no search
        return None
    for key in ((cache_key(op, M, K, N, dtype, group_size, tag=tag),)
                if tag else ()) + (cache_key(op, M, K, N, dtype, group_size),):
        hit = _CACHE.get(key)
        if hit is not None:
            return {k: v for k, v in hit.items() if k != "us"}
    return None


def candidate_plans(op: str, M: int, K: int, N: int, dtype: str,
                    group_size: int = 0) -> List[Dict]:
    """The op's search space at this shape, the rule's entry included."""
    return tuning(op).candidates(M, K, N, group_size, dtype)


# --------------------------------------------------------------- search ----
#: bytes written between timed calls: more than the H100's 50 MB L2, so each
#: call reads its weights from device memory, as a layer's GEMM does in a
#: serving step (the other layers' weights evicted them)
L2_FLUSH_BYTES = 64 << 20


def _default_timer(fn: Callable[[], object], reps: int = 10,
                   warmup: int = 2) -> float:
    """Median device time of one call in microseconds: CUDA events around
    each of `reps` calls, L2 flushed before each, after `warmup` calls.
    The card sleeps while the host enqueues them (twice the host's time a
    call, from the warm-up, at ~2 GHz), so the events bracket the calls'
    device work and not the host's launch overhead."""
    import time

    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / max(1, warmup)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(4e9 * reps * host_s + 1e6, 5e8)))
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(statistics.median(a.elapsed_time(b) * 1e3
                                   for a, b in pairs))


def tune(op: str, make_call: Callable[[Dict], Callable[[], object]],
         M: int, K: int, N: int, dtype: str, *,
         group_size: int = 0, tag: str = "",
         candidates: Optional[Iterable[Dict]] = None,
         timer: Callable[[Callable[[], object]], float] = _default_timer,
         path: Optional[str] = None, save: bool = True
         ) -> Tuple[Dict, float]:
    """Time `make_call(entry)()` over the candidate plans, persist the best.

    `make_call` binds the kernel's arguments and returns a zero-arg
    callable that launches with that plan (the CUDA wrappers take it as
    ``plan=``).  A candidate the kernel cannot take at this shape is
    skipped, not fatal: it fails the op's check here, or raises ValueError
    in the wrapper before any launch.  Returns (best entry, best us).
    """
    ensure_loaded()
    t = tuning(op)
    cands = list(candidates) if candidates is not None \
        else t.candidates(M, K, N, group_size, dtype)
    best, best_us = None, float("inf")
    for entry in cands:
        try:
            t.check(entry, M, K, N, group_size, dtype)
            us = timer(make_call(entry))
        except _TILE_REJECT_ERRORS:
            global_registry().counter(
                "autotune_tiles_rejected_total",
                "autotune candidates skipped: a plan the kernel cannot take",
                op=op).inc()
            continue
        if us < best_us:
            best, best_us = dict(entry), us
    if best is None:
        # every candidate failed: the rule's plan, NOT persisted —
        # float("inf") is not valid JSON and a dead entry would shadow a
        # future successful search
        return t.rule(M, K, N, group_size, dtype), float("inf")
    entry = {**best, "us": best_us}
    _CACHE[cache_key(op, M, K, N, dtype, group_size, tag=tag)] = entry
    if tag:                                # untagged key serves other sites
        _CACHE.setdefault(cache_key(op, M, K, N, dtype, group_size), entry)
    if save:
        save_cache(path)
    return best, best_us


# ------------------------------------------------------ attention tiles ----
#: attention ops reuse the (bm, bn, bk) entry format: bk = kv tokens per
#: program (pages_per_program * page_size for the paged ops, with page
#: size in the group_size slot), bn = KV-head tile, bm = q tile
ATTN_OPS = ("attn.paged_decode", "attn.prefill", "attn.ragged")
_PAGED_ATTN_OPS = ("attn.paged_decode", "attn.ragged")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def attn_default_blocks(op: str, M: int, K: int, N: int,
                        group_size: int = 0) -> Dict[str, int]:
    """Heuristic tiles for the attention ops (M = batch rows or q length,
    K = kv context length, N = H * hd)."""
    if op in _PAGED_ATTN_OPS:
        ps = max(1, group_size)
        target = 256 if ps < 8 else 512
        bk = max(ps, min(_round_up(K, ps), _round_up(target, ps)))
        return {"bm": 1, "bn": 0, "bk": bk}
    bq = 128 if M >= 128 else max(8, _round_up(M, 8))
    bk = 128 if K >= 128 else max(8, _round_up(K, 8))
    return {"bm": bq, "bn": 0, "bk": bk}
