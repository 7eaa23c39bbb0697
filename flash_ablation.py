"""Ablations of flash prefill (``csrc/flash_prefill.cu``) on one NVIDIA GPU:
the row tile a CTA takes, PV with one bf16 P instead of hi + lo, how much
of the time is the L2 flush (memory latency) the timings include, what a
launch that does nothing costs, and what each part of a K/V tile's work
costs (the variants with it taken out).

    python3 flash_ablation.py [variant ...]      (default: all of VARIANTS)

Each variant is a copy of ``src/repro_torch`` (with edits to
``csrc/flash_prefill.cu`` where it has any) under the gitignored
``src/repro_torch/_build/ablation_flash/<variant>/``, run with a fixed plan
where it names one (``flash_plan`` patched: ``r<rows>k<key split>``, 16 to
64 rows a CTA, 1, 2 or 4 warps a 16-row tile) and with or without the L2
flush before each call.
All copies build at once, one ``nvcc`` each; then each variant that
keeps the function (not ``floor`` nor the ``no_`` ones) is checked against the plain version (max |diff| reported;
``chip_smoke.ATTN_ATOL`` held) and timed in its own process at every ``chip_smoke.FLASH_CASES``
shape: CUDA events, ``chip_smoke.Timer``.  Prints the card's name and
power limit, then one JSON line per variant.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "repro_torch"
OUT = PKG / "_build" / "ablation_flash"
CU = "csrc/flash_prefill.cu"

_LO_MMAS = """          mma_bf16(o[2 * dd], pl, vf[0], vf[1]);
          mma_bf16(o[2 * dd + 1], ph, vf[2], vf[3]);
          mma_bf16(o[2 * dd + 1], pl, vf[2], vf[3]);"""

_KERNEL_START = """  using L = Smem<HD>;
  constexpr int LD = L::LD;"""

#: name -> (edits [(file, old, new)], (rows, key split) a CTA or None for
#: the plan's, flush the L2 before each call, check against the plain
#: version)
VARIANTS = {
    "base": ([], None, True, True),
    **{f"r{r}k{ks}": ([], (r, ks), True, True)
       for r, ks in ((16, 1), (32, 1), (64, 1), (16, 2), (32, 2), (64, 2),
                     (16, 4), (32, 4))},
    # PV with p rounded once to bf16: one MMA a V fragment, not two
    "one_p": ([(CU, _LO_MMAS, """          mma_bf16(o[2 * dd + 1], ph, vf[2], vf[3]);""")], None, True,
              True),
    # the same kernel with q/k/v/positions left in the L2 by the last call
    "warm": ([], None, False, True),
    # the launch alone: the kernel returns at once (its output is garbage)
    "floor": ([(CU, _KERNEL_START, "  if (Sq > 0) return;\n" + _KERNEL_START)],
              None, True, False),
    # parts taken out, to see what a K/V tile's time is made of (outputs
    # wrong, not checked): QK's MMAs, PV's MMAs, the exponentials, the K/V
    # loads after the first tile
    "no_qk": ([(CU, """          mma_bf16(s[2 * nn], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], kf[2], kf[3]);""", "")],
              None, True, False),
    "no_pv": ([(CU, """          mma_bf16(o[2 * dd], ph, vf[0], vf[1]);
""" + _LO_MMAS, "")], None, True, False),
    "no_exp": ([(CU, "expf(s[j][e] - na), pb = expf(s[j][2 + e] - nb)",
                 "(s[j][e] - na), pb = (s[j][2 + e] - nb)")],
               None, True, False),
    "no_load": ([(CU, """    if (kt + STAGES - 1 <= hi)
      load_tile(kt + STAGES - 1, (n + STAGES - 1) % STAGES);""", "")],
                None, True, False),
    # deeper K/V rings: 3 and 4 tiles (2 in flight behind the one computed,
    # or 3)
    "stages3": ([(CU, "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
                None, True, True),
    "stages4": ([(CU, "constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
                None, True, True),
}

_TIME = r"""
import dataclasses, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.autotune import attn_default_blocks

plan, flush = json.loads(sys.argv[3]), sys.argv[4] == "1"
check = sys.argv[5] == "1"
plan_of = pa.flash_plan
if plan:
    rows, ks = plan
    def fixed(B, Sq, Skv, H, KV, hd):
        p = plan_of(B, Sq, Skv, H, KV, hd)
        grid = (-(-(H // KV) * Sq // rows), KV, B)
        warps = rows // 16 * ks
        return dataclasses.replace(
            p, rows=rows, key_split=ks, warps=warps, grid=grid,
            ctas=grid[0] * KV * B, smem=pa.flash_smem(hd, rows, warps))
    pa.flash_plan = fixed
timer = cs.Timer(torch)
if not flush:
    timer.flush_buf = torch.empty(0, dtype=torch.uint8, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
res = {}
for case, (Sq, Skv, n_real, hit, nh, nkv, hd) in cs.FLASH_CASES.items():
    q, k, v, qpos, kpos = cs._flash_inputs(torch, gen, Sq, Skv, n_real, hit,
                                           nh, nkv, hd)
    bk = attn_default_blocks("attn.prefill", Sq, Skv, nh * hd)["bk"]
    got = pa.flash_prefill_cuda(q, k, v, qpos, kpos)
    want = pa.flash_prefill_plain(q, k, v, qpos, kpos, bk=bk)
    err = (got.float() - want.float()).abs().max().item() if check else None
    if check and err > cs.ATTN_ATOL:
        raise SystemExit(f"{case}: max |diff| {err} > {cs.ATTN_ATOL}")
    t = timer.ms(lambda: pa.flash_prefill_cuda(q, k, v, qpos, kpos))
    p = pa.flash_plan(1, Sq, Skv, nh, nkv, hd)
    res[case] = {"ms": t, "max_abs_err": err, "ctas": p.ctas,
                 "warps": p.warps}
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
        raise SystemExit("flash_ablation: needs an NVIDIA GPU")
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    trees = {n: _variant_tree(n) for n in names}
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.build_all(['flash_prefill'])", str(tree)])
        for n, tree in trees.items()}
    for n, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"{n}: build failed")
    for n, tree in trees.items():
        _, plan, flush, check = VARIANTS[n]
        out = subprocess.run(
            [sys.executable, "-c", _TIME, str(tree), str(ROOT),
             json.dumps(plan),
             "1" if flush else "0", "1" if check else "0"],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"{n}: {out.stderr[-2000:]}")
        print(json.dumps({"variant": n,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
