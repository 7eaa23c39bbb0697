"""Ablations of the W4A4 tensor-core GEMM (``csrc/int4_matmul.cu``, both
entries) on one NVIDIA GPU: what each part of a call costs.

    python3 w4a4_ablation.py [variant ...]      (default: all of VARIANTS)

Each variant is a copy of ``src/repro_torch`` with edits to
``csrc/int4_matmul.cu`` (or to the plan in ``kernels/int4_matmul.py``),
under the gitignored ``src/repro_torch/_build/ablation_w4a4/<variant>/``.
All variants build at once, one ``nvcc`` each; then each is timed in its
own process at the four projection shapes of qwen2-0.5b at M = 8, 64 and
256, through both entries (the fused one on x, the unfused one on the same
activations quantized beforehand: the difference is what the fused
quantize costs): CUDA events with the L2 flushed before each call
(``chip_smoke.Timer``), and one layer's 7 projections summed.  Variants
that keep the function are checked bit for bit against the plain versions;
the others (``no*``, ``floor*``) compute garbage and are only timed.
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
OUT = PKG / "_build" / "ablation_w4a4"
CU = "csrc/int4_matmul.cu"
PY = "kernels/int4_matmul.py"

#: the plan's split rule off: one split, no cluster, whatever the grid
_NOSPLIT = (PY, "    if tiles < TARGET_CTAS:\n", "    if False:\n")
_KERNEL_START = "  using L = Layout<BM, BN, FUSED>;\n"

#: name -> ([(file, old, new), ...], checked against the plain versions)
VARIANTS = {
    "base": ([], True),
    # one split a call: the tiles alone, each walking all Kh packed rows
    "nosplit": ([_NOSPLIT], True),
    # no tensor-core work: each MMA replaced by one integer op on its inputs
    "nomma": ([(CU, """  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
                """  d[0] += a[0] ^ b0; d[1] += a[1] ^ b1; d[2] += a[2] ^ b0;
  d[3] += a[3] ^ b1;""")], False),
    # no weight bytes loaded: the ring's weight slots are never written
    "noload": ([(CU, "          cp_async16(dst, ok ? src : w, ok);\n",
                 "")], False),
    # the fused quantize without its division (a cast of the bits)
    "noquant": ([(CU, "  float v = rintf(__fdiv_rn(x, s));\n",
                  "  float v = (float)(__float_as_int(x) & 7) + s * 0.0f;\n")],
                False),
    # 128-column tiles at every 64-row tile (each x row quantized by half
    # as many CTAs)
    "bn128": ([(PY, "    bn = 128 if bm == 64 and -(-M // 64) * -(-N // 128) "
                    ">= TARGET_CTAS \\\n        else 64\n",
                "    bn = 128 if bm == 64 else 64\n")], True),
    # the ring's depth (4 in the kernel; a k-step waits for the one after
    # it, so 3 stages prefetch one step, 6 stages four)
    "stages3": ([(CU, "constexpr int STAGES = 4; ",
                  "constexpr int STAGES = 3; ")], True),
    "stages6": ([(CU, "constexpr int STAGES = 4; ",
                  "constexpr int STAGES = 6; ")], True),
    # an empty launch of the same grid and cluster (the floor of a call)
    "floor": ([(CU, _KERNEL_START, "  if (M > 0) return;\n" + _KERNEL_START)],
              False),
    # ... and without the cluster: one split
    "floor_nosplit": ([(CU, _KERNEL_START,
                        "  if (M > 0) return;\n" + _KERNEL_START),
                       _NOSPLIT], False),
}

#: M of the timed calls: decode, the ragged budget, the largest bucket
ROWS = (8, 64, 256)

_TIME = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.core.quant import quant_scale, quantize
from repro_torch.kernels.int4_matmul import (
    int4_matmul_cuda, int4_matmul_fused_cuda, int4_matmul_fused_plain,
    w4a4_plan)
from repro_torch.kernels.packing import pack_kmajor

checked = json.loads(sys.argv[4])
timer = cs.Timer(torch)
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
res = {}
for (K, N), per_layer in cs.GEMM_SHAPES:
    w_km = pack_kmajor(torch.randint(-8, 8, (K, N), generator=gen,
                                     device="cuda", dtype=torch.int8))
    w_s = torch.rand((1, N), generator=gen, device="cuda") * 0.01 + 1e-3
    for M in json.loads(sys.argv[3]):
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16).to(torch.float32)
        a_s = quant_scale(x, axis=1, bits=4)
        a_q = quantize(x, a_s, bits=4)
        fused = int4_matmul_fused_cuda(x, w_km, w_s)
        if checked and not (
                torch.equal(fused, int4_matmul_fused_plain(x, w_km, w_s))
                and torch.equal(fused, int4_matmul_cuda(a_q, a_s, w_km,
                                                        w_s))):
            raise SystemExit(f"M={M} K={K} N={N}: differs from the plain "
                             "version")
        t_f = timer.ms(lambda: int4_matmul_fused_cuda(x, w_km, w_s))
        t_u = timer.ms(lambda: int4_matmul_cuda(a_q, a_s, w_km, w_s))
        p = w4a4_plan(M, K, N, K // 2)
        row = res.setdefault(f"M={M}", {"fused_layer_ms": 0.0,
                                        "unfused_layer_ms": 0.0})
        row[f"{K}x{N}"] = {"fused": t_f, "unfused": t_u,
                           "plan": [p.bm, p.bn, p.splits, p.ctas]}
        row["fused_layer_ms"] += per_layer * t_f
        row["unfused_layer_ms"] += per_layer * t_u
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
        raise SystemExit("w4a4_ablation: needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    trees = {n: _variant_tree(n) for n in names}
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build_all(['int4_matmul'])", str(tree)])
        for n, tree in trees.items()}
    for n, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"{n}: build failed")
    for n, tree in trees.items():
        out = subprocess.run(
            [sys.executable, "-c", _TIME, str(tree), str(ROOT),
             json.dumps(ROWS), json.dumps(VARIANTS[n][1])],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{n}: {out.stderr[-2000:]}")
        print(json.dumps({"variant": n,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
