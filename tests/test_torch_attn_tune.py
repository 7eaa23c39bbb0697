"""The attention ops' plan search (``repro_torch/kernels/autotune.py``:
``"attn.paged_decode"``, ``"attn.ragged"``, ``"attn.prefill"``), on the CPU.

What a wrapper would launch is read without a card: its operands are CPU
tensors that report a CUDA device, and ``_build.load`` returns a recording
library whose launch functions return 0, so the split or plan is read as
the kernel would get it and nothing is launched.  Checked:

  * each op's rule entry is the split or plan the wrappers took before the
    search existed (``decode_plan`` / ``flash_plan``) at every config's
    shapes, and with no cache file every launch takes it;
  * every candidate passes its op's check, and entries the kernels cannot
    take raise ValueError before any launch: more than 8 splits, a split
    of part of a page, an hd-256 key split other than 4, a plan tuned at
    another (KV, hd);
  * ``decode_split_ok`` and the relaxed ``plan_ok`` of
    ``csrc/decode_common.cuh`` agree, statement for statement;
  * a paged-decode and a ragged lookup of one table give one split, and
    both wrappers launch it;
  * a wrapper builds and checks a cached entry once, and a loaded cache
    changes nothing else;
  * the plain versions' blocking is still the JAX package's
    ``attn_default_blocks`` and never reads the cache.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels import _build, autotune, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ragged_attention as ra  # noqa: E402

CUH = Path(__file__).resolve().parent.parent / "src" / "repro_torch" \
    / "csrc" / "decode_common.cuh"

#: the configs served on the paged layout, as (H, KV, hd); the decode
#: kernels are built for hd 64 and 128, flash prefill also for 256
ATTN_SHAPES = sorted({(c.n_heads, c.n_kv_heads, c.hd)
                      for c in REGISTRY.values()
                      if c.n_heads % c.n_kv_heads == 0})
DECODE_SHAPES = [s for s in ATTN_SHAPES
                 if pa.DECODE_MAX_GROUP.get(s[2], 0) >= s[0] // s[1]]
FLASH_SHAPES = [s for s in ATTN_SHAPES if s[2] in pa.FLASH_HEAD_DIMS]
#: serving tables (width in tokens, page size): max_ctx 512 at ps 16 (the
#: main path), the CLI's 128 at 16, 1-token pages, 12-token pages, a
#: 32k-token table
TABLES = [(512, 16), (128, 16), (130, 1), (96, 12), (32768, 16)]
#: (B, Sq, Skv): the prompt buckets fresh, a tail over a longer cache
PREFILLS = [(1, 256, 256), (1, 32, 32), (2, 64, 64), (8, 256, 256),
            (1, 64, 512)]
POOLS = ("bfloat16", "int8", "uint8")


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.ENV_CACHE_PATH, str(path))
    autotune.reset()
    yield path
    autotune.reset()


class _OnCuda(torch.Tensor):
    """A CPU tensor that passes the attention wrappers' device check."""

    @property
    def device(self):
        return torch.device("cuda")


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def launched(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "load", lambda name, bind: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    counts = ops.launch_counts()
    yield lib
    ops.reset_launch_counts()
    ops.add_launch_counts(counts)


def _cuda(*ts):
    return [None if t is None else t.as_subclass(_OnCuda) for t in ts]


def _decode_operands(rows, H, KV, hd, width, ps, pool="bfloat16", seed=0):
    """q [rows, H, hd] bf16, pools of P pages (int8 / int4 with scales),
    a table [rows, width / ps] and last positions."""
    rng = np.random.default_rng(seed)
    pps = width // ps
    P = rows * pps
    q = torch.from_numpy(rng.standard_normal((rows, H, hd)).astype(
        np.float32)).to(torch.bfloat16)
    if pool == "bfloat16":
        k = torch.zeros((P, ps, KV, hd), dtype=torch.bfloat16)
        ks = None
    else:
        w = hd // 2 if pool == "uint8" else hd
        k = torch.zeros((P, ps, KV, w), dtype=getattr(torch, pool))
        ks = torch.ones((P, ps, KV, 1), dtype=torch.float32)
    tbl = torch.arange(rows * pps, dtype=torch.int32).reshape(rows, pps)
    last = torch.full((rows,), width - 1, dtype=torch.int32)
    return q, k, k.clone(), ks, None if ks is None else ks.clone(), tbl, last


def _paged_split(lib, *ops_, plan=None):
    """(split_tok, nsplit) the paged decode wrapper launches."""
    q, k, v, ks, vs, tbl, last = _cuda(*ops_)
    lib.calls.clear()
    pa.paged_decode_attention_cuda(q, k, v, tbl, last, ks, vs, plan=plan)
    assert [c[0] for c in lib.calls] == ["paged_decode_launch"]
    return lib.calls[0][1][-3:-1]


def _ragged_split(lib, *ops_, plan=None):
    """(split_tok, nsplit) the ragged wrapper launches for a decode-only
    pack of the table's rows."""
    q, k, v, ks, vs, tbl, last = _cuda(*ops_)
    slots = torch.arange(q.shape[0], dtype=torch.int32).as_subclass(_OnCuda)
    lib.calls.clear()
    ra.ragged_decode_attention_cuda(q, k, v, tbl, slots, last, ks, vs,
                                    plan=plan)
    assert [c[0] for c in lib.calls] == ["ragged_decode_launch"]
    return lib.calls[0][1][-3:-1]


def _flash_operands(B, Sq, Skv, H, KV, hd):
    q = torch.zeros((B, Sq, H, hd), dtype=torch.bfloat16)
    k = torch.zeros((B, Skv, KV, hd), dtype=torch.bfloat16)
    qpos = torch.arange(Sq, dtype=torch.int32).repeat(B, 1)
    kpos = torch.arange(Skv, dtype=torch.int32).repeat(B, 1)
    return q, k, k.clone(), qpos, kpos


def _flash_launch(lib, *ops_, plan=None):
    """(warps, key_split) the flash wrapper launches."""
    lib.calls.clear()
    pa.flash_prefill_cuda(*_cuda(*ops_), plan=plan)
    assert [c[0] for c in lib.calls] == ["flash_prefill_launch"]
    return lib.calls[0][1][-3:-1]


def _flash_key(B, Sq, Skv, H, KV, hd):
    return (B, Sq), Skv, (H, hd), "bfloat16", KV


# ------------------------------------------------------------ the rules --
@pytest.mark.parametrize("width,ps", TABLES)
def test_decode_rule_is_the_split_before_the_search(launched, width, ps):
    """The rule's entry is `decode_plan`'s split at every config's shape
    and pool, and with no cache file both wrappers launch it."""
    want = pa.decode_plan(width, ps)
    for H, KV, hd in DECODE_SHAPES:
        for pool in POOLS:
            rule = autotune.tuning("attn.paged_decode").rule(
                KV, width, hd, ps, pool)
            assert rule == {"split_tok": want.split_tok,
                            "nsplit": want.nsplit}
            assert autotune.tuning("attn.ragged").rule(
                KV, width, hd, ps, pool) == rule
    H, KV, hd = DECODE_SHAPES[0]
    if width <= 512:
        for pool in POOLS:
            args = _decode_operands(3, H, KV, hd, width, ps, pool)
            assert _paged_split(launched, *args) \
                == (want.split_tok, want.nsplit)
            assert _ragged_split(launched, *args) \
                == (want.split_tok, want.nsplit)


@pytest.mark.parametrize("B,Sq,Skv", PREFILLS)
def test_flash_rule_is_the_plan_before_the_search(launched, B, Sq, Skv):
    for H, KV, hd in FLASH_SHAPES:
        want = pa.flash_plan(B, Sq, Skv, H, KV, hd)
        M, K, N, dtype, G = _flash_key(B, Sq, Skv, H, KV, hd)
        rule = autotune.tuning("attn.prefill").rule(M, K, N, G, dtype)
        assert rule == {"rows": want.rows, "key_split": want.key_split}
        assert pa.flash_plan_from(rule, B, Sq, Skv, H, KV, hd) == want
        assert _flash_launch(launched, *_flash_operands(
            B, Sq, Skv, H, KV, hd)) == (want.warps, want.key_split)


# ------------------------------------------------------- the candidates --
@pytest.mark.parametrize("width,ps", TABLES)
def test_decode_candidates_are_every_split_the_kernels_take(width, ps):
    """One candidate a distinct nsplit of 1 to 8, the rule's first, each
    passing the check at every built head dim and pool."""
    cands = autotune.candidate_plans("attn.paged_decode", 2, width, 64,
                                     "bfloat16", ps)
    assert cands == autotune.candidate_plans("attn.ragged", 2, width, 64,
                                             "bfloat16", ps)
    assert cands[0] == autotune.tuning("attn.paged_decode").rule(
        2, width, 64, ps, "bfloat16")
    nsplits = [c["nsplit"] for c in cands]
    assert len(set(nsplits)) == len(nsplits)
    want = {-(-width // (-(-(-(-width // n)) // ps) * ps))
            for n in range(1, pa.DECODE_MAX_SPLITS + 1)}
    assert set(nsplits) == want | {cands[0]["nsplit"]}
    for c in cands:
        for hd in pa.DECODE_MAX_GROUP:
            for pool in POOLS:
                p = autotune.tuning("attn.paged_decode").check(
                    c, 2, width, hd, ps, pool)
                assert (p.split_tok, p.nsplit) == (c["split_tok"],
                                                   c["nsplit"])
                assert pa.decode_split_ok(width, ps, p.split_tok, p.nsplit)


@pytest.mark.parametrize("B,Sq,Skv", PREFILLS)
def test_flash_candidates_are_every_plan_the_kernel_takes(B, Sq, Skv):
    for H, KV, hd in FLASH_SHAPES:
        M, K, N, dtype, G = _flash_key(B, Sq, Skv, H, KV, hd)
        cands = autotune.candidate_plans("attn.prefill", M, K, N, dtype, G)
        assert cands[0] == autotune.tuning("attn.prefill").rule(
            M, K, N, G, dtype)
        splits = (4,) if hd == 256 else pa.FLASH_KEY_SPLITS
        want = [{"rows": r, "key_split": s} for s in splits
                for r in pa.FLASH_ROWS
                if r // 16 * s <= pa.FLASH_MAX_WARPS]
        assert sorted(map(str, cands)) == sorted(map(str, want))
        for c in cands:
            p = autotune.tuning("attn.prefill").check(c, M, K, N, G, dtype)
            assert p.warps == c["rows"] // 16 * c["key_split"] <= 8
            assert p.smem <= pa.MAX_SMEM_BYTES


@pytest.mark.parametrize("entry,why", [
    ({"split_tok": 48}, "11 splits of 48 tokens: more than 8"),
    ({"split_tok": 72}, "72 tokens: part of a 16-token page"),
    ({"split_tok": 1024}, "wider than the 512-token table"),
    ({"split_tok": 128, "nsplit": 8}, "128 tokens a split make 4"),
    ({"split_tok": 0}, "no tokens"),
    ({"split_tok": "64"}, "not an integer"),
    ({"nsplit": 8}, "no split_tok"),
])
def test_decode_entry_the_kernels_cannot_take_is_refused(launched, entry,
                                                         why):
    """Refused by the check, by a wrapper handed it, and by a wrapper that
    reads it from the cache; nothing launched; skipped when loaded from a
    file."""
    with pytest.raises(ValueError):
        autotune.tuning("attn.paged_decode").check(entry, 2, 512, 64, 16,
                                                   "bfloat16")
    args = _decode_operands(2, 14, 2, 64, 512, 16)
    for split in (_paged_split, _ragged_split):
        with pytest.raises(ValueError):
            split(launched, *args, plan=entry)
        assert launched.calls == []
    key = autotune.cache_key("attn.paged_decode", 2, 512, 64, "bfloat16", 16)
    autotune._CACHE[key] = entry
    for split in (_paged_split, _ragged_split):
        for _ in range(2):                 # refused at every call, never kept
            with pytest.raises(ValueError):
                split(launched, *args)
            assert launched.calls == []
    assert not autotune._entry_ok(key, entry)


@pytest.mark.parametrize("entry,shape,why", [
    ({"rows": 16, "key_split": 2}, (1, 256, 256, 16, 1, 256),
     "hd 256 takes key split 4 only"),
    ({"rows": 64, "key_split": 4}, (1, 256, 256, 14, 2, 64),
     "16 warps"),
    ({"rows": 48, "key_split": 2}, (1, 256, 256, 14, 2, 64),
     "48 rows is no row tile count"),
    ({"rows": 16, "key_split": 3}, (1, 256, 256, 14, 2, 64),
     "key split 3 is not built"),
    ({"rows": 64, "key_split": 1}, (1, 256, 256, 16, 1, 256),
     "tuned at (2, 128): at (1, 256) the kernel cannot take it"),
    ({"rows": 128, "key_split": 1}, (1, 256, 256, 16, 1, 256),
     "tuned at (2, 64): at (1, 256) the kernel cannot take it"),
])
def test_flash_entry_the_kernel_cannot_take_is_refused(launched, entry,
                                                       shape, why):
    M, K, N, dtype, G = _flash_key(*shape)
    with pytest.raises(ValueError):
        autotune.tuning("attn.prefill").check(entry, M, K, N, G, dtype)
    operands = _flash_operands(*shape)
    with pytest.raises(ValueError):
        _flash_launch(launched, *operands, plan=entry)
    assert launched.calls == []
    key = autotune.cache_key("attn.prefill", M, K, N, dtype, G)
    autotune._CACHE[key] = entry
    with pytest.raises(ValueError):
        _flash_launch(launched, *operands)
    assert launched.calls == []
    assert not autotune._entry_ok(key, entry)


def test_flash_entry_is_never_applied_at_another_kv_or_head_dim(launched):
    """The key holds the whole launch shape: an entry tuned at qwen2-0.5b's
    (14 heads over 2, hd 64) is read at that shape only; qwen3-4b's (32
    over 8, hd 128), recurrentgemma-9b's (16 over 1, hd 256) and another
    batch take their rules."""
    shape = (1, 256, 256, 14, 2, 64)
    entry = {"rows": 128, "key_split": 1}
    M, K, N, dtype, G = _flash_key(*shape)
    autotune.tune("attn.prefill", lambda e: (lambda: e), M, K, N, dtype,
                  group_size=G, candidates=[entry], timer=lambda fn: 1.0)
    assert _flash_launch(launched, *_flash_operands(*shape)) == (8, 1)
    for other in ((1, 256, 256, 32, 8, 128), (1, 256, 256, 16, 1, 256),
                  (2, 256, 256, 14, 2, 64), (1, 256, 256, 14, 7, 64)):
        assert autotune.lookup("attn.prefill",
                               *_flash_key(*other)[:4],
                               _flash_key(*other)[4]) is None
        want = pa.flash_plan(*other)
        assert _flash_launch(launched, *_flash_operands(*other)) \
            == (want.warps, want.key_split)


# ------------------------------------------------------ the kernel mirror --
def _c_plan_ok(pps, ps, split_tok, nsplit):
    """csrc/decode_common.cuh::plan_ok, statement by statement."""
    if pps < 1 or ps < 1:
        return False
    width = pps * ps
    if split_tok < ps or split_tok % ps or split_tok > width:
        return False
    return nsplit == (width + split_tok - 1) // split_tok and nsplit >= 1 \
        and nsplit <= pa.DECODE_MAX_SPLITS


def test_split_check_mirrors_the_kernel_source():
    """The relaxed ``plan_ok`` is `decode_split_ok` (widths and splits of
    every size up to 4096 tokens, page sizes 1, 4, 12, 16), the rule's
    split and every candidate pass it, and both launchers still refuse
    what it refuses."""
    src = CUH.read_text()
    body = src[src.index("inline bool plan_ok("):]
    body = body[:body.index("\n}\n")]
    for stmt in ("if (pps < 1 || ps < 1) return false;",
                 "const int width = pps * ps;",
                 "if (split_tok < ps || split_tok % ps || split_tok > width) "
                 "return false;",
                 "return nsplit == (width + split_tok - 1) / split_tok && "
                 "nsplit >= 1\n      && nsplit <= MAX_SPLITS;"):
        assert stmt in body, stmt
    for f in ("paged_decode.cu", "ragged_decode.cu"):
        assert "!plan_ok(pps, ps, split_tok, nsplit)" in \
            (CUH.parent / f).read_text(), f
    for ps in (1, 4, 12, 16):
        for pps in list(range(1, 40)) + [128, 256 // ps + 1]:
            width = pps * ps
            rule = pa.decode_plan(width, ps)
            assert _c_plan_ok(pps, ps, rule.split_tok, rule.nsplit)
            for c in pa.decode_candidates(0, width, 0, ps):
                assert _c_plan_ok(pps, ps, c["split_tok"], c["nsplit"])
            for split_tok in range(0, width + 2 * ps):
                for nsplit in range(0, 10):
                    assert _c_plan_ok(pps, ps, split_tok, nsplit) \
                        == pa.decode_split_ok(width, ps, split_tok, nsplit)


def test_decode_table_entries_fit_beside_the_static_smem():
    """`decode_static_smem` is ``sizeof(Smem<HD, MAXG>)`` as the source's
    comment counts it (46,944 bytes at hd 128, 25,120 at hd 64), and one
    split of a 32k-token table fits a CTA at both head dims."""
    src = CUH.read_text()
    assert "46,944 bytes at HD 128" in src and "(25,120 at HD 64" in src
    assert pa.decode_static_smem(128) == 46944
    assert pa.decode_static_smem(64) == 25120
    for hd in (64, 128):
        p = pa.decode_plan_from({"split_tok": 32768}, 32768, 16, hd)
        assert (p.nsplit, p.pages) == (1, 2048)


# ------------------------------------------------- one split for both --
@pytest.mark.parametrize("pool", POOLS)
def test_paged_and_ragged_lookups_give_one_split(launched, pool):
    """A split tuned through either name is the one entry both wrappers
    read: the paged batch (B rows) and a decode-only ragged pack of a
    max_batch-row table launch it alike; another pool dtype, page size,
    KV or head dim keeps the rule."""
    H, KV, hd = 14, 2, 64
    entry = {"split_tok": 128, "nsplit": 4}
    for name in ("attn.ragged", "attn.paged_decode"):
        autotune.reset()
        autotune.tune(name, lambda e: (lambda: e), KV, 512, hd, pool,
                      group_size=16, candidates=[entry],
                      timer=lambda fn: 1.0)
        assert autotune.lookup("attn.paged_decode", KV, 512, hd, pool, 16) \
            == autotune.lookup("attn.ragged", KV, 512, hd, pool, 16) \
            == entry
        for rows in (1, 8):
            args = _decode_operands(rows, H, KV, hd, 512, 16, pool)
            assert _paged_split(launched, *args) == (128, 4)
            assert _ragged_split(launched, *args) == (128, 4)
        rule = pa.decode_plan(512, 16)
        for other in ((H, KV, hd, 512, 4), (28, 4, 64, 512, 16),
                      (14, 2, 128, 512, 16), (H, KV, hd, 256, 16)):
            args = _decode_operands(2, *other, pool)
            want = pa.decode_plan(other[3], other[4])
            assert _paged_split(launched, *args) == _ragged_split(
                launched, *args) == (want.split_tok, want.nsplit)
        assert rule.nsplit == 8
    assert list(autotune._CACHE) == [autotune.cache_key(
        "attn.paged_decode", KV, 512, hd, pool, 16)]


def test_saved_attention_entries_round_trip(isolated_cache, launched):
    """Saved, dropped and read back: each wrapper takes the tuned entry;
    an "attn.ragged" key written by hand is skipped (the entry lives under
    "attn.paged_decode")."""
    autotune.tune("attn.ragged", lambda e: (lambda: e), 2, 512, 64, "int8",
                  group_size=16, candidates=[{"split_tok": 256,
                                              "nsplit": 2}],
                  timer=lambda fn: 1.0, save=False)
    M, K, N, dtype, G = _flash_key(1, 256, 256, 14, 2, 64)
    autotune.tune("attn.prefill", lambda e: (lambda: e), M, K, N, dtype,
                  group_size=G, candidates=[{"rows": 32, "key_split": 2}],
                  timer=lambda fn: 1.0)
    data = json.loads(isolated_cache.read_text())
    data["attn.ragged|m2|k512|n64|int8|g16|cuda"] = {"split_tok": 64}
    isolated_cache.write_text(json.dumps(data))
    autotune.reset()
    assert autotune.load_cache() == 2
    args = _decode_operands(8, 14, 2, 64, 512, 16, "int8")
    assert _ragged_split(launched, *args) == _paged_split(launched, *args) \
        == (256, 2)
    assert _flash_launch(launched, *_flash_operands(
        1, 256, 256, 14, 2, 64)) == (4, 2)


# ------------------------------------------------------ the host's cost --
def test_a_cached_entry_is_checked_once(monkeypatch, launched):
    """A wrapper builds and checks a cached entry at its first read only,
    for the attention ops and the GEMMs alike; a new entry for the shape
    is read again."""
    from repro_torch.kernels import int4_matmul as i4

    built = []
    for mod, name in ((pa, "decode_plan_from"), (pa, "flash_plan_from"),
                      (i4, "w4a4_plan_from")):
        real = getattr(mod, name)

        def spy(*a, real=real, name=name):
            built.append(name)
            return real(*a)
        monkeypatch.setattr(mod, name, spy)
    key = autotune.cache_key("attn.paged_decode", 2, 512, 64, "bfloat16", 16)
    autotune._CACHE[key] = {"split_tok": 128}
    M, K, N, dtype, G = _flash_key(1, 256, 256, 14, 2, 64)
    autotune._CACHE[autotune.cache_key("attn.prefill", M, K, N, dtype, G)] \
        = {"rows": 32, "key_split": 2}
    autotune._CACHE[autotune.cache_key("int4_matmul", 8, 896, 4864,
                                       "float32")] = \
        {"bm": 16, "bn": 64, "rows": 224, "splits": 2}
    for _ in range(3):
        assert pa.decode_plan_for(torch.zeros((8, 32), dtype=torch.int32),
                                  torch.zeros((4, 16, 2, 64),
                                              dtype=torch.bfloat16)
                                  ).nsplit == 4
        assert pa.flash_launch_plan(1, 256, 256, 14, 2, 64).rows == 32
        assert i4.launch_plan(8, 896, 4864, 448, True, "float32").rows == 224
    assert sorted(built) == ["decode_plan_from", "flash_plan_from",
                             "w4a4_plan_from"]
    autotune._CACHE[key] = {"split_tok": 256}
    assert pa.decode_plan_for(torch.zeros((8, 32), dtype=torch.int32),
                              torch.zeros((4, 16, 2, 64),
                                          dtype=torch.bfloat16)).nsplit == 2
    assert built.count("decode_plan_from") == 2


# ---------------------------------------------------- the plain versions --
def test_plain_blocking_is_the_jax_default_and_ignores_the_cache(
        monkeypatch):
    """The plain versions' tiles equal the JAX package's
    ``attn_default_blocks`` at every shape here, and on CPU tensors the ops
    give the same outputs with tuned entries cached and never ask the
    cache."""
    from repro.kernels import autotune as jat

    for op in ("attn.paged_decode", "attn.ragged"):
        for width, ps in TABLES:
            for M in (1, 8, 64):
                assert autotune.attn_default_blocks(
                    op, M, width, 896, group_size=ps) \
                    == jat.attn_default_blocks(op, M, width, 896,
                                               group_size=ps)
    for B, Sq, Skv in PREFILLS + [(1, 7, 7), (1, 100, 300)]:
        for H, KV, hd in FLASH_SHAPES:
            assert autotune.attn_default_blocks(
                "attn.prefill", Sq, Skv, H * hd) \
                == jat.attn_default_blocks("attn.prefill", Sq, Skv, H * hd)

    rng = np.random.default_rng(3)
    H, KV, hd, ps, pps, B = 14, 2, 64, 4, 8, 3
    P = B * pps
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((P, ps, KV, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    tbl = torch.arange(P, dtype=torch.int32).reshape(B, pps)
    last = torch.tensor([31, 5, -1], dtype=torch.int32)
    slots = torch.arange(B, dtype=torch.int32)
    qp = torch.from_numpy(rng.standard_normal((1, 20, H, hd)).astype(
        np.float32)).to(torch.bfloat16)
    kp = torch.from_numpy(rng.standard_normal((1, 20, KV, hd)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(20, dtype=torch.int32)[None]
    calls = (lambda: ops.paged_decode_attention(q, k, v, tbl, last),
             lambda: ops.ragged_paged_attention(q, k, v, tbl, slots, last),
             lambda: ops.flash_prefill(qp, kp, kp, pos, pos))
    before = [c() for c in calls]
    autotune._CACHE[autotune.cache_key("attn.paged_decode", KV, pps * ps,
                                       hd, "bfloat16", ps)] = \
        {"split_tok": 4}
    autotune._CACHE[autotune.cache_key(
        "attn.prefill", (1, 20), 20, (H, hd), "bfloat16", KV)] = \
        {"rows": 16, "key_split": 1}

    def no_cache(*a, **kw):
        raise AssertionError("a plain version read the plan cache")

    monkeypatch.setattr(autotune, "lookup", no_cache)
    monkeypatch.setattr(autotune, "tuned_plan", no_cache)
    for c, b in zip(calls, before):
        assert torch.equal(c(), b)
