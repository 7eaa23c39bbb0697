"""Ablations of the table-lookup GEMM (``csrc/lut4_matmul.cu``) on one
NVIDIA GPU: how each path's way of fetching a product compares with the
others.

    python3 lut4_ablation.py [variant ...]      (default: all of VARIANTS)

Each variant is a copy of ``src/repro_torch`` with edits to
``csrc/lut4_matmul.cu``, under the gitignored
``src/repro_torch/_build/ablation_lut4/<variant>/``.  All variants build at
once, one ``nvcc`` each; then each is checked bit-exact against the plain
version and timed in its own process at the four projection shapes of
qwen2-0.5b at M = 8, 64 and 256: CUDA events with the L2 flushed before
each call (``chip_smoke.Timer``), and one layer's 7 projections summed.
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
OUT = PKG / "_build" / "ablation_lut4"
CU = "csrc/lut4_matmul.cu"

_W_SEL_PICK = """        uint32_t sl[NQ], ml[NQ], sh[NQ], mh[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          sl[q] = selector(wd[q]);
          ml[q] = half_mask(wd[q]);
          sh[q] = selector(wd[q] >> 4);
          mh[q] = half_mask(wd[q] >> 4);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const uint4 c_lo = t4[code_lo[i]], c_hi = t4[code_hi[i]];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const uint32_t s = pick(c_lo, sl[q], ml[q])
                               + pick(c_hi, sh[q], mh[q]);
            ev[i][q] += prmt(s, 0u, 0x4240u);
            od[i][q] += prmt(s, 0u, 0x4341u);
          }
        }
"""

#: the tile rule: A_SEL at 64 rows a CTA, W_SEL below
_RULE = "  static constexpr bool A_SEL = BM == 64;"

#: name -> [(file, old, new), ...]
VARIANTS = {
    "base": [],
    # each path in the other orientation: W_SEL at 64 rows, A_SEL at 4 to
    # 16 rows (it picks four rows at once; 1 and 2 rows stay W_SEL), both
    # with the 4-row x 16-column thread tile
    "swap": [(CU, _RULE,
              "  static constexpr bool A_SEL = BM != 64 && BM >= 4;"),
             (CU, "  static constexpr int TM = A_SEL ? 16 : (BM < 4 ? BM : 4);",
              "  static constexpr int TM = BM < 4 ? BM : 4;"),
             (CU, "  static constexpr int TN = A_SEL ? 4 : 16;",
              "  static constexpr int TN = 16;")],
    # split K alone: no register lookup, every product two signed byte
    # reads of the shared table (unbiased) and an add, W_SEL's tile
    "bytes": [(CU, _RULE, "  static constexpr bool A_SEL = false;"),
              (CU, "constexpr int BIAS = 56;", "constexpr int BIAS = 0;"),
              (CU, _W_SEL_PICK, """        const int8_t* t8 = reinterpret_cast<const int8_t*>(table);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const uint32_t b_lo = (uint32_t)code_lo[i] << 4;
          const uint32_t b_hi = (uint32_t)code_hi[i] << 4;
#pragma unroll
          for (int v = 0; v < TN; ++v) {
            const uint32_t byte = (wd[v / 4] >> (8 * (v % 4))) & 0xFFu;
            acc[i][v] += (int)t8[b_lo | (byte & 0xFu)]
                         + (int)t8[b_hi | (byte >> 4)];
          }
        }
""")],
}

#: M of the timed calls: decode, the ragged budget, the largest bucket
ROWS = (8, 64, 256)

_TIME = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.kernels.int4_matmul import int4_matmul_plain
from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda
from repro_torch.kernels.packing import pack_kmajor

timer = cs.Timer(torch)
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 18)
res = {}
for (K, N), per_layer in cs.GEMM_SHAPES:
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device="cuda", dtype=torch.int8))
    w_s = torch.rand((1, N), generator=gen, device="cuda") * 0.01 + 1e-3
    for M in json.loads(sys.argv[3]):
        a_q = torch.randint(-8, 8, (M, K), generator=gen, device="cuda",
                            dtype=torch.int8)
        a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.1 + 1e-3
        if not torch.equal(lut4_matmul_cuda(a_q, a_s, w_km, w_s),
                           int4_matmul_plain(a_q, a_s, w_km, w_s)):
            raise SystemExit(f"M={M} K={K} N={N}: differs from the plain "
                             "version")
        t = timer.ms(lambda: lut4_matmul_cuda(a_q, a_s, w_km, w_s))
        row = res.setdefault(f"M={M}", {"layer_ms": 0.0})
        row[f"{K}x{N}"] = t
        row["layer_ms"] += per_layer * t
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
    for rel, old, new in VARIANTS[name]:
        path = dst / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {rel} no longer holds {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst.parent


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lut4_ablation: needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    trees = {n: _variant_tree(n) for n in names}
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build_all(['lut4_matmul'])", str(tree)])
        for n, tree in trees.items()}
    for n, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"{n}: build failed")
    for n, tree in trees.items():
        out = subprocess.run(
            [sys.executable, "-c", _TIME, str(tree), str(ROOT),
             json.dumps(ROWS)], capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{n}: {out.stderr[-2000:]}")
        print(json.dumps({"variant": n,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
