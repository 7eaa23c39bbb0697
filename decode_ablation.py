"""Ablations of the split-context decode kernels (``csrc/paged_decode.cu``,
``csrc/ragged_decode.cu``, body in ``csrc/decode_common.cuh``) and of the
elementwise table kernel (``csrc/lut_mul4.cu``) on one NVIDIA GPU: what
each part of a call costs.

    python3 decode_ablation.py [variant ...]    (default: all of VARIANTS)

A variant named more than once is timed again at each place, so two
variants can be timed in turns (``onecopy lanecopies onecopy lanecopies``).

Each variant is a copy of ``src/repro_torch`` with edits to a kernel source
(or to a plan in ``kernels/``), under the gitignored
``src/repro_torch/_build/ablation_decode/<variant>/``.  All variants build
at once, one ``nvcc`` each; then each is timed in its own process with
CUDA events, the L2 flushed before each call (``chip_smoke.Timer``):

- the decode variants on the paged decode check's operands
  (``chip_smoke.decode_inputs``: batch 8, a 512-token table of pages of 16,
  846 live tokens) for the bf16, int8 and int4 pools, and on the ragged
  step's pack (``chip_smoke._ragged_pack``, T = 64) for the int8 pool;
- the lut_mul4 variants on 1M int8 elements (``chip_smoke.MUL4_N``).

Variants that keep the function are checked against the plain versions
(attention within ``chip_smoke.ATTN_ATOL``, lut_mul4 exactly); the others
(``noload``, ``qk8``, ``pv1``, ``nomerge``, the floors) compute garbage
or nothing and are only timed.
``floor`` times the empty kernels the libraries carry for it
(``decode_floor_cuda``, ``lut_mul4_floor_cuda``) on the calls' grids.
Prints the card's name and power limit, then one JSON line per variant.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "repro_torch"
OUT = PKG / "_build" / "ablation_decode"
CUH = "csrc/decode_common.cuh"
MUL4 = "csrc/lut_mul4.cu"
PLAN = "kernels/paged_attention.py"

#: name -> ([(file, old, new), ...], what it times ("decode" | "mul4"),
#: checked against the plain versions, libraries to build)
VARIANTS = {
    "base": ([], "decode", True, ("paged_decode", "ragged_decode")),
    # one CTA a row (no cluster): the split rule gives the whole width, in
    # the kernel and in the wrapper's plan
    "nosplit": ([(CUH, "  int lo = (width + MAX_SPLITS - 1) / MAX_SPLITS;\n",
                  "  int lo = width;\n"),
                 (PLAN, "    lo = max(-(-width // DECODE_MAX_SPLITS), "
                        "min(DECODE_MIN_SPLIT_TOK, width))\n",
                  "    lo = width\n")],
                "decode", True, ("paged_decode", "ragged_decode")),
    # 4-byte K/V loads instead of 16-byte ones
    "narrow": ([(CUH, "constexpr int LOAD_BYTES = 16;",
                 "constexpr int LOAD_BYTES = 4;")],
               "decode", True, ("paged_decode", "ragged_decode")),
    # no K/V bytes loaded: the staged rows are zeros
    "noload": ([(CUH, "        const PoolT* pool = is_v ? vpool : kpool;\n",
                 "        const PoolT* pool = is_v ? vpool : kpool;\n"
                 "        if (t >= 0) { raw[i] = V{}; continue; }\n")],
               "decode", False, ("paged_decode", "ragged_decode")),
    # the QK dot over 8 of the 64 dims
    "qk8": ([(CUH, "        for (int c = 0; c < HD; c += 8) {\n",
              "        for (int c = 0; c < 8; c += 8) {\n")],
            "decode", False, ("paged_decode", "ragged_decode")),
    # PV over one token a round
    "pv1": ([(CUH, "      for (int j = 0; j < n; ++j) {\n",
              "      for (int j = 0; j < min(n, 1); ++j) {\n")],
            "decode", False, ("paged_decode", "ragged_decode")),
    # no merge: each CTA writes from its partial and leaves, no wait, no
    # cluster barrier, no distributed shared-memory read
    "nomerge": ([(CUH, "  cg::cluster_group cluster = cg::this_cluster();\n",
                  "  if (nsplit > 0) {\n"
                  "    if (warp < G) out[warp * HD + 2 * lane] = "
                  "__float2bfloat16_rn(acc0 + acc1 + l + m);\n"
                  "    return;\n  }\n"
                  "  cg::cluster_group cluster = cg::this_cluster();\n")],
                "decode", False, ("paged_decode", "ragged_decode")),
    # one cluster barrier: no arrive at entry and no wait before the push
    "nowait": ([(CUH, "  if (nsplit > 1) cluster_arrive_relaxed();", ""),
                (CUH, "  if (nsplit > 1) cluster_wait();\n", "")],
               "decode", True, ("paged_decode", "ragged_decode")),
    # an empty launch of the same grid and cluster
    "floor": ([], "decode_floor", False, ("paged_decode",)),
    # lut_mul4: one 256-byte table copy (the kernel's layout) ...
    "onecopy": ([], "mul4", True, ("lut_mul4",)),
    # ... against 32 lane-private copies (8 KB, no bank shared in a warp)
    # (word w of lane l at [w * 32 + l]; each thread fills 8 lanes' copies
    # of one word)
    "lanecopies": ([(MUL4, "  uint32_t w[64];\n", "  uint32_t w[64 * 32];\n"),
                    (MUL4, "    if (threadIdx.x < 64) w[threadIdx.x] = "
                           "lut[threadIdx.x];\n",
                     "    constexpr int LPT = 64 * 32 / THREADS;\n"
                     "    const int word = threadIdx.x / (32 / LPT);\n"
                     "    const int l0 = threadIdx.x % (32 / LPT) * LPT;\n"
                     "    const uint32_t v = lut[word];\n"
                     "#pragma unroll\n"
                     "    for (int l = 0; l < LPT; ++l) "
                     "w[word * 32 + l0 + l] = v;\n"),
                    (MUL4, "    return (w[idx >> 2] >> ",
                     "    return (w[(idx >> 2) * 32 + threadIdx.x % 32] >> ")],
                   "mul4", True, ("lut_mul4",)),
    # every element a byte load and a byte store (16 a thread)
    "bytes": ([(MUL4, "  *vec = ra == (uintptr_t)b % 16 && ra == "
                      "(uintptr_t)out % 16;\n",
                "  *vec = 0;\n")], "mul4", True, ("lut_mul4",)),
    # blocks of 512 threads (one table copy for twice the elements)
    "threads512": ([(MUL4, "constexpr int THREADS = 256;",
                     "constexpr int THREADS = 512;")],
                   "mul4", True, ("lut_mul4",)),
    "mul4_floor": ([], "mul4_floor", False, ("lut_mul4",)),
}

_TIME = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs

kind, checked = sys.argv[3], json.loads(sys.argv[4])
timer = cs.Timer(torch)
dev = torch.device("cuda")
res = {}
if kind.startswith("decode"):
    from repro_torch.kernels.paged_attention import (
        decode_floor_cuda, decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    from repro_torch.kernels.ragged_attention import (
        ragged_decode_attention_cuda, ragged_decode_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    q, tbl, lp, pools = cs.decode_inputs(torch, gen)
    ps, pps = cs.PAGE_SIZE, cs.DECODE_PPS
    B = q.shape[0]
    slot, pos, row_last = cs._ragged_pack(torch)
    T = slot.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    rtbl = cs._table(torch, gen, len(row_last), 320, pps, row_last)
    rq = torch.randn((T, cs.H, cs.HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    rpools = cs._pools(torch, gen, 320, ps)
    res["plan"] = str(decode_plan(pps * ps, ps))
    if kind == "decode_floor":
        res["paged_ms"] = timer.ms(lambda: decode_floor_cuda(B, cs.KV, ps,
                                                             pps, dev))
        res["ragged_ms"] = timer.ms(lambda: decode_floor_cuda(T, cs.KV, ps,
                                                              pps, dev))
    else:
        for dt in cs.POOL_DTYPES:
            k, v, ks, vs = pools[dt]
            if checked:
                got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs)
                want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs)
                err = (got.float() - want.float()).abs().max().item()
                if err > cs.ATTN_ATOL:
                    raise SystemExit(f"paged {dt}: max |diff| {err}")
            res[f"paged_{dt}_ms"] = timer.ms(
                lambda: paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs))
        k, v, ks, vs = rpools["int8"]
        if checked:
            got = ragged_decode_attention_cuda(rq, k, v, rtbl, slot, pos, ks,
                                               vs)
            want = ragged_decode_attention_plain(rq, k, v, rtbl, slot, pos,
                                                 ks, vs)
            err = (got.float() - want.float()).abs().max().item()
            if err > cs.ATTN_ATOL:
                raise SystemExit(f"ragged int8: max |diff| {err}")
        res["ragged_int8_ms"] = timer.ms(
            lambda: ragged_decode_attention_cuda(rq, k, v, rtbl, slot, pos,
                                                 ks, vs))
else:
    from repro_torch.kernels.lut_mul4 import (
        lut_mul4_cuda, lut_mul4_floor_cuda, lut_mul4_plain)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    a, b = (torch.randint(-8, 8, (cs.MUL4_N,), generator=gen, device="cuda",
                          dtype=torch.int8) for _ in range(2))
    if kind == "mul4_floor":
        out = torch.empty_like(a)
        res["mul4_ms"] = timer.ms(lambda: lut_mul4_floor_cuda(a, b, out))
    else:
        if checked:
            for x, y in ((a, b), (a[1:], b[1:]), (a[3:], b[:-3])):
                if not torch.equal(lut_mul4_cuda(x, y), lut_mul4_plain(x, y)):
                    raise SystemExit("lut_mul4 differs from the plain version")
        res["mul4_ms"] = timer.ms(lambda: lut_mul4_cuda(a, b))
    res["torch_mul_ms"] = timer.ms(lambda: torch.mul(a, b))
print(json.dumps(res))
"""


def _variant_tree(name: str) -> Path:
    """A copy of the port with the variant's edits; raises where an edit's
    text is not in the source (the kernel moved on)."""
    dst = OUT / name / "repro_torch"
    if dst.parent.exists():
        shutil.rmtree(dst.parent)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for rel, old, new in VARIANTS[name][0]:
        path = dst / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {rel} no longer holds {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst.parent


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_ablation: needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"decode_ablation: unknown variants "
                         f"{sorted(unknown)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    trees = {n: _variant_tree(n) for n in names}
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build_all(sys.argv[2].split(','))", str(tree),
         ",".join(VARIANTS[n][3])])
        for n, tree in trees.items()}
    for n, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"{n}: build failed")
    for n in names:
        tree = trees[n]
        _, kind, checked, _ = VARIANTS[n]
        out = subprocess.run(
            [sys.executable, "-c", _TIME, str(tree), str(ROOT), kind,
             json.dumps(checked)], capture_output=True, text=True,
            timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{n}: {out.stderr[-2000:]}")
        print(json.dumps({"variant": n,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
