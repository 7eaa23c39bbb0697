"""Ablations of the W4A16 tensor-core kernel (M > 16, bf16 x) on one
NVIDIA GPU: what each part of a k-step costs.

    python3 w4a16_ablation.py [variant ...]      (default: all of VARIANTS)

Each variant is a copy of ``src/repro_torch`` with edits to
``csrc/w4a16_matmul.cu`` (or to the row-tile rule in
``kernels/w4a16_matmul.py``), under the gitignored
``src/repro_torch/_build/ablation/<variant>/``.  All variants build at
once, one ``nvcc`` each; then each is timed in its own process at the four
projection shapes of qwen2-0.5b, grouped (G = 128) and per channel, at
M = 32 and 256: CUDA events with the L2 flushed before each call
(``chip_smoke.Timer``), and one layer's 7 projections summed.  Variants
that drop work (the ``no*`` ones) compute garbage and are only timed;
the others are held to ``chip_smoke.W4A16_RTOL`` of the plain version.
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
OUT = PKG / "_build" / "ablation"
CU = "csrc/w4a16_matmul.cu"
PY = "kernels/w4a16_matmul.py"

#: dynamic shared memory for the ring, so it may pass the 48 KB a launch
#: gets without asking
_DYNAMIC_SMEM = [
    (CU, "static_assert(sizeof(MmaSmem) <= 48 * 1024, \"static shared memory\");",
     ""),
    (CU, "  __shared__ MmaSmem sm;\n",
     "  extern __shared__ __align__(16) uint8_t smem_raw[];\n"
     "  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(smem_raw);\n"),
    (CU, "    w4a16_mma_kernel<GROUPED, KSTEP, BM_><<<grid, MMA_THREADS, 0, st>>>(     \\",
     "    cudaFuncSetAttribute(w4a16_mma_kernel<GROUPED, KSTEP, BM_>,             \\\n"
     "        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(MmaSmem)); \\\n"
     "    w4a16_mma_kernel<GROUPED, KSTEP, BM_><<<grid, MMA_THREADS,               \\\n"
     "        sizeof(MmaSmem), st>>>(                                             \\"),
]


def _stages(n):
    return _DYNAMIC_SMEM + [(CU, "constexpr int MMA_STAGES = 3;",
                             f"constexpr int MMA_STAGES = {n};")]


#: name -> ([(file, old, new), ...], checked against the plain version)
VARIANTS = {
    "base": ([], True),
    # the row-tile rule off: 64 rows a CTA whatever the grid
    "bm64": ([(PY, "    bm = 64 if -(-M // 64) * -(-N // 64) >= "
                   "SPLITK_TARGET_CTAS else 32\n", "    bm = 64\n")], True),
    # the ring's depth (3 in the kernel)
    "stages2": ([(CU, "constexpr int MMA_STAGES = 3;",
                  "constexpr int MMA_STAGES = 2;")], True),
    "stages6": (_stages(6), True),
    "stages12": (_stages(12), True),
    # 64 packed rows a k-step (32 in the kernel), two stages
    "kstep64": ([(CU, "constexpr int XS_LD = BKH + 8;",
                  "constexpr int XS_LD = 64 + 8;"),
                 (CU, "constexpr int MMA_STAGES = 3;",
                  "constexpr int MMA_STAGES = 2;"),
                 (CU, "uint8_t w[MMA_STAGES][BKH][WS_LD];",
                  "uint8_t w[MMA_STAGES][64][WS_LD];"),
                 (CU, "static_assert(KSTEP == 16 || KSTEP == BKH, "
                      "\"a k-step of 16 or 32 rows\");", ""),
                 (CU, "return launch_mma<GROUPED, BKH>(",
                  "return launch_mma<GROUPED, 64>("),
                 (CU, "if (G % BKH != 0)\n          return launch_mma<true, 16>(",
                  "if (G % 64 != 0)\n          return launch_mma<true, 16>(")],
                True),
    # no tensor-core work: the MMA replaced by one integer op on its inputs
    "nomma": ([(CU, """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
                "  d[0] += __int_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);")],
              False),
    # no loads into the ring at all
    "noload": ([(CU, "  auto load_step = [&](int t) {\n    if (t < nsteps) {",
                 "  auto load_step = [&](int t) {\n    if (t < 0) {")], False),
    # no x loads (the weight's stay)
    "noxload": ([(CU, "for (int e = tid; e < 2 * BM * (KSTEP / 8); "
                      "e += MMA_THREADS) {",
                  "for (int e = tid; e < 0; e += MMA_THREADS) {")], False),
    # no widening: the B fragments are the raw bytes
    "nowiden": ([(CU, """  uint32_t v = __byte_perm(u, WIDEN_BITS >> 8, sel);
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __float2bfloat162_rn(WIDEN_BIAS));
  return *reinterpret_cast<uint32_t*>(&h);""", "  return u ^ sel;")], False),
}

#: M of the timed calls: a prefill bucket, and the largest
ROWS = (32, 256)

_TIME = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.core.quant import group_quantize, pack_int4
from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
from repro_torch.kernels.w4a16_matmul import (w4a16_matmul_cuda,
                                              w4a16_matmul_plain)

check = sys.argv[3] == "1"
timer = cs.Timer(torch)
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
res = {}
for (K, N), per_layer in cs.GEMM_SHAPES:
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    for form, G in (("channel", K), ("g128", 128)):
        w_q, w_scale = group_quantize(w, G)
        w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
        for M in json.loads(sys.argv[4]):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = w4a16_matmul_cuda(x, w_km, w_scale, G)
            if check:
                want = w4a16_matmul_plain(x, w_km, w_scale, G)
                err = (got - want).abs().max().item()
                if not err <= cs.W4A16_RTOL * want.abs().max().item():
                    raise SystemExit(f"{form} M={M} K={K} N={N}: {err}")
            t = timer.ms(lambda: w4a16_matmul_cuda(x, w_km, w_scale, G))
            row = res.setdefault(f"{form} M={M}", {"layer_ms": 0.0})
            row[f"{K}x{N}"] = t
            row["layer_ms"] += per_layer * t
print(json.dumps(res))
"""


def _variant_tree(name: str) -> Path:
    """A copy of the port with the variant's edits; raises where an edit's
    text is not in the source (the kernel moved on)."""
    edits, _ = VARIANTS[name]
    dst = OUT / name / "repro_torch"
    if dst.parent.exists():
        shutil.rmtree(dst.parent)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for rel, old, new in edits:
        path = dst / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {rel} no longer holds {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst.parent


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("w4a16_ablation: needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    trees = {n: _variant_tree(n) for n in names}
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build_all(['w4a16_matmul'])", str(tree)])
        for n, tree in trees.items()}
    for n, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"{n}: build failed")
    for n, tree in trees.items():
        out = subprocess.run(
            [sys.executable, "-c", _TIME, str(tree), str(ROOT),
             "1" if VARIANTS[n][1] else "0", json.dumps(ROWS)],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{n}: {out.stderr[-2000:]}")
        print(json.dumps({"variant": n,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
