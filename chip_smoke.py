"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. device   -- the card's name and power limit (nvidia-smi); refuses to
                 run without CUDA or outside a checkout of the repository.
  2. build    -- compiles every CUDA kernel under src/repro_torch/csrc, one
                 nvcc per source, all started together.
  3. kernels  -- each kernel against its plain PyTorch version on the same
                 inputs at the serving paths' shapes: the fused W4A4 GEMM
                 bit for bit at M = 1, 8, 16, 17, 32, 64, 128 and 256 rows
                 (each shape's `w4a4_plan` printed, two calls bit-equal at
                 M = 8, 64 and 256, its kernels' ptxas registers and spill,
                 and a method gate: `cuobjdump -sass` shows IMMA in every
                 w4a4_ kernel), the attention kernels
                 within atol 2e-2 (bf16) on bf16, int8 and int4 pools with
                 padding rows exactly 0 (flash prefill at the prompt
                 buckets 32, 128 and 256, a prefix-hit tail and qwen3-4b's
                 hd 128, each with and without a window, two calls
                 bit-equal, each shape's plan printed, its ptxas report,
                 and a method gate: `cuobjdump -sass` shows HMMA in every
                 flash kernel), paged decode and the ragged kernel with
                 and without a window, two calls bit-equal, each one's
                 split plan, ptxas report (no spill) and floor (an empty
                 launch of the same grid and cluster) printed, and a
                 decode-only pack through the ragged kernel bit for bit
                 equal to the paged decode kernel; the W4A16 GEMM per
                 channel and grouped (G = 128), on bf16 and f32
                 activations, within W4A16_RTOL (M <= 16
                 through the split-K kernel and its reduce, each shape's
                 plan printed; M > 16 through the tensor-core kernel for
                 bf16 x and the FFMA kernel for f32 x, each shape's
                 kernel printed, with the tensor-core kernel's ptxas
                 registers, spill and shared memory; two calls bit-equal
                 at M = 8, 64 and 256; both rows reported); the
                 table-lookup GEMM and the unfused W4A4 GEMM bit for bit,
                 and equal to each other, at M = 1, 8, 16, 17, 32, 64,
                 128 and 256 (the table-lookup kernel's `lut4_plan`
                 printed per shape, both two calls bit-equal at M = 8, 64
                 and 256, its kernels' ptxas registers and spill, its
                 method's floor, and a method gate: `cuobjdump -sass`
                 shows no IDP, IMMA or HMMA in any lut4_ kernel); the
                 elementwise table product exactly, both strategies, on
                 a tail and on operands off 16-byte alignment, its floor
                 printed.
                 Times (CUDA events, L2 flushed
                 before each call) for the kernel, the plain version and a
                 PyTorch yardstick, beside the least time the card could
                 take (bytes over 3.35 TB/s or operations over the
                 int8/bf16 peak, whichever is larger); the integer GEMMs'
                 yardstick at M <= 16, where torch._int_mm does not run,
                 is a float32 torch.matmul on the int values (exact while
                 |acc| < 2^24).
  4. serve    -- full-width qwen2-0.5b (24 layers, random weights from a
                 seed) serves through InferenceEngine on cuda, each step
                 shape captured in a CUDA graph and replayed: with
                 W4A4-packed projections, a Poisson trace on the bucketed
                 step (bf16 paged KV pool, flash prefill, fused paged
                 decode), then a mixed trace on the ragged step (int8 pool,
                 token budget 64, ragged decode); then the Poisson trace on
                 the bucketed step under the pre-packed grouped W4A16 plan
                 (W4A16_PLAN) and under lut4 (on-the-fly weights from the
                 same masters), whose tokens must equal the W4A4 run's.
                 Every request must finish ok with tokens in [0, vocab),
                 every parameter and cache tensor must live on the card,
                 and each run must launch the kernels of its path (counts
                 zeroed just before the run; a replay adds its graph's
                 launches) and none of the other path's attention kernels
                 or the other plans' GEMMs, and capture no step shape it
                 has seen before (recompiles.steady_state 0; captures by
                 step function printed).  Each run is then served again
                 on the same trace by an engine whose steps run eagerly:
                 every request's tokens and the launch counts must equal
                 the captured run's.  After each of the two runs a few
                 steps at full batch run under torch.profiler: step time,
                 host launches and device kernels per step (the run's
                 GEMM 7 per layer), the card's busy share, the run's GEMM
                 kernels' device time and the largest kernels, then the
                 captured step beside the eager one.  Then the
                 public entry points no serving path reaches (ops.mul4,
                 ops.int4_matmul), called as the JAX package's quickstart
                 and benchmarks call theirs.
  5. cpu      -- full width cut to 2 layers, on cuda and on cpu with the
                 same weights.  Bucketed: one prefill and three decode
                 steps with float weights in bf16 (logits within CPU_ATOL),
                 the serving path's W4A4 weights in float32 through the
                 CUDA GEMM (logits within CPU_W4A4_F32_ATOL), the serving
                 path itself, W4A4 in bf16 (correlation reported, see
                 phase_cpu), W4A16 weights in bf16 per channel and grouped
                 (within CPU_ATOL) and the mixed_sensitive plan in float32
                 (within CPU_W4A4_F32_ATOL).  Ragged: a pack of two
                 prefill chunks and padding, then three ragged decode
                 steps, float weights in bf16 on a bf16 pool and on an int8
                 pool (logits of the emitted rows within CPU_ATOL on both).

The line before the last is a JSON object with every kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: card peaks used for bounds (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12

#: attention kernels vs their plain versions (bf16 outputs)
ATTN_ATOL = 2e-2
#: card vs CPU logits, 2 layers at full width in bf16 with float weights:
#: a few bf16 steps (1/64 at |logit| ~ 4) of accumulated rounding
CPU_ATOL = 0.25
#: ... with the serving path's W4A4 weights in float32: the integer GEMM is
#: exact on both devices, the rest differs by float32 rounding
CPU_W4A4_F32_ATOL = 1e-3
#: ... and the serving path itself, W4A4 in bf16 (see phase_cpu)
CPU_W4A4_CORR = 0.7
#: the W4A16 kernel against its plain version, relative to the output's
#: largest magnitude: both sum exact products in f32 (the plain version
#: dequantizes the weight first, the kernel scales each group's partial
#: sum), so they differ by f32 rounding in the order of the sums, ~1e-6
W4A16_RTOL = 1e-4
#: qwen2-0.5b's layers; every one runs 7 projections a forward
LAYERS = 24

SEED = 0
#: ~2 ms of device time at H100 clocks: longer than the host needs to
#: enqueue any timed call
SLEEP_CYCLES = 4_000_000
MAX_BATCH = 8
PAGE_SIZE = 16
PROMPT_BUCKET = 256
#: the ragged step's auto token budget at MAX_BATCH and PAGE_SIZE:
#: prompt_bucket(8 + 2 * 16)
BUDGET = 64
#: qwen2-0.5b's attention: query heads, KV heads, head dim
H, KV, HD = 14, 2, 64
POOL_DTYPES = ("bfloat16", "int8", "int4")
#: bytes per K/V element of each pool, and of its scales per (token, head)
POOL_BYTES = {"bfloat16": (2.0, 0), "int8": (1.0, 4), "int4": (0.5, 4)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(*args) -> None:
    print(*args, flush=True)


# ------------------------------------------------------------- timing ----
class Timer:
    """Per-call CUDA-event timing of device time.  Before each call the L2
    cache is flushed (a 64 MiB write, larger than the card's 50 MB L2), so
    weights and pools come from device memory as on the serving path, and
    the card is kept busy (``torch.cuda._sleep``) while the host enqueues
    the call, so the events bracket the call's device work and not the
    host's launch overhead.  A call that synchronizes inside (the plain
    decode version reads the batch's last position) still includes the
    host time after its sync."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 1 ----
def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible; driver "
        f"{driver or 'unknown'}; nvcc: {nvcc[-1] if nvcc else 'unknown'})")
    say(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")
    return kind, (smi[0] if smi else "unavailable")


# ------------------------------------------------------------ phase 2 ----
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    for name, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas[{name}]: {line.strip()}")
    compiled = sorted(n for n, (now, _) in built.items() if now)
    reused = sorted(n for n, (now, _) in built.items() if not now)
    say(f"build: compiled {compiled} in {secs:.1f} s, reused {reused}")


# ------------------------------------------------------------ phase 3 ----
#: (K, N) of qwen2-0.5b's projections and how many of each one layer runs:
#: wq + wo (896, 896), wk + wv (896, 128), w_in + w_gate (896, 4864),
#: w_out (4864, 896)
GEMM_SHAPES = (((896, 896), 2), ((896, 128), 2), ((896, 4864), 2),
               ((4864, 896), 1))


def _gemm_inputs(torch, gen, M, K, N):
    from repro_torch.kernels.packing import pack_kmajor

    # bf16-valued activations (the model's residual stream), as f32
    x = torch.randn((M, K), generator=gen, device="cuda").to(
        torch.bfloat16).to(torch.float32)
    w_q = torch.randint(-8, 8, (K, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_scale = torch.rand((1, N), generator=gen, device="cuda") * 0.01 + 1e-3
    return x, w_q, pack_kmajor(w_q).contiguous(), w_scale


def _int_yardstick_ms(torch, timer, a_q, w_q):
    """One PyTorch call computing the integer GEMM of int8 a_q [M, K] and
    w_q [K, N]: torch._int_mm where M > 16 (its minimum), else
    torch.matmul in float32 on the int values (exact while |acc| < 2^24;
    TF32 is off)."""
    if a_q.shape[0] > 16:
        return timer.ms(lambda: torch._int_mm(a_q, w_q))
    a_f, w_f = a_q.float(), w_q.float()
    return timer.ms(lambda: torch.matmul(a_f, w_f))


#: the rows both W4A4 entries are checked at: decode rows, the 16 / 17 tile
#: boundary, the prefill buckets 32 and 128, the ragged budget and the
#: largest prompt bucket (the same as the table-lookup kernel's)
GEMM_ROWS = (1, MAX_BATCH, 16, 17, 32, BUDGET, 128, PROMPT_BUCKET)


def check_gemm(torch, timer):
    """The fused W4A4 kernel against its plain version, bit for bit, at
    every main-path (K, N) and every M of GEMM_ROWS (each shape's
    `w4a4_plan` printed), two calls bit-equal at M = 8, 64 and 256; the
    ptxas registers and spill of every w4a4_ kernel and the SASS gate (IMMA
    in each).  Yardsticks: torch._int_mm on int8 operands where M > 16 (its
    minimum); at M <= 16 torch.matmul in float32 on the int values (one
    call, exact while |acc| < 2^24; TF32 is off).  The result's top level
    is one layer at M = 256; `at_budget` and `at_decode` hold M = 64 and
    M = 8, `per_shape_ms` every timed shape."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.int4_matmul import (
        int4_matmul_fused_cuda, int4_matmul_fused_plain, w4a4_plan)

    ptxas = ptxas_report(_build.build_all(["int4_matmul"])["int4_matmul"][1],
                         "w4a4_")
    if not ptxas:
        fail("w4a4: no ptxas report of a w4a4_ kernel in the build log")
    for name, (regs, spill, smem) in sorted(ptxas.items()):
        say(f"ptxas {name}: {regs} registers, {spill} bytes spill")
    n_sass = w4a4_sass_gate()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    worst = 0.0
    for M in GEMM_ROWS:
        for (K, N), per_layer in GEMM_SHAPES:
            x, w_q, w_km, w_scale = _gemm_inputs(torch, gen, M, K, N)
            p = w4a4_plan(M, K, N, w_km.shape[0], w_km.data_ptr() % 16 == 0)
            say(f"w4a4 plan M={M:4d} K={K:5d} N={N:5d}: {p.bm} x {p.bn} CTA "
                f"tiles, {p.vec}-byte weight loads, {p.splits} splits of "
                f"{p.rows} packed rows (one cluster a tile), {p.ctas} CTAs")
            got = int4_matmul_fused_cuda(x, w_km, w_scale)
            want = int4_matmul_fused_plain(x, w_km, w_scale)
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"int4_matmul_fused M={M} K={K} N={N}: kernel differs "
                     f"from the plain version (max |diff| {err})")
            if M in (MAX_BATCH, BUDGET, PROMPT_BUCKET) and not torch.equal(
                    got, int4_matmul_fused_cuda(x, w_km, w_scale)):
                fail(f"int4_matmul_fused M={M} K={K} N={N}: two calls on the "
                     "same inputs differ")
            n_bytes = M * K * 4 + w_km.numel() + N * 4 + M * N * 4
            n_ops = 2.0 * M * K * N
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
            t = timer.ms(lambda: int4_matmul_fused_cuda(x, w_km, w_scale))
            tp = timer.ms(lambda: int4_matmul_fused_plain(x, w_km, w_scale),
                          reps=5)
            a8 = torch.clamp(torch.round(x * 7.0 / x.abs().amax()), -8,
                             7).to(torch.int8)
            lib = _int_yardstick_ms(torch, timer, a8, w_q)
            say(f"gemm M={M:4d} K={K:5d} N={N:5d}: bit-exact; kernel "
                f"{t:.4f} ms, plain {tp:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), "
                + (f"_int_mm {lib:.4f}" if M > 16 else
                   f"f32 matmul (exact, |acc| < 2^24) {lib:.4f}"))
            rows[(M, K, N)] = {"ms": t, "plain_ms": tp, "bound_ms": b_ms,
                               "library_ms": lib, "bytes": n_bytes,
                               "ops": n_ops}
    say(f"w4a4: fused kernel bit-exact at M={list(GEMM_ROWS)}, two calls "
        f"bit-equal at M={MAX_BATCH}, {BUDGET} and {PROMPT_BUCKET}, every "
        "shape")
    return {"shape": f"one layer's 7 projections at M={PROMPT_BUCKET} "
                     f"(M={MAX_BATCH} under 'at_decode', M={BUDGET} under "
                     "'at_budget'; yardstick _int_mm, at M <= 16 a float32 "
                     "torch.matmul on the int values)",
            "max_abs_err": worst,
            **_layer_sum(rows, PROMPT_BUCKET, INT8_OPS_PER_S),
            "at_decode": _layer_sum(rows, MAX_BATCH, INT8_OPS_PER_S),
            "at_budget": _layer_sum(rows, BUDGET, INT8_OPS_PER_S),
            "per_shape_ms": {f"M={M} K={K} N={N}": r["ms"]
                             for (M, K, N), r in sorted(rows.items())},
            "ptxas": {name: {"registers": r, "spill_bytes": sp}
                      for name, (r, sp, _) in sorted(ptxas.items())},
            "sass_kernels_checked": n_sass}


def _layer_sum(rows, M, peak):
    """One layer's 7 projections at M rows: each per-shape timing weighted
    by how many of that shape a layer runs; bound by bytes or by operations
    at `peak` over the layer's sums."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes", "ops")
    out = dict.fromkeys(keys, 0.0)
    for (K, N), per_layer in GEMM_SHAPES:
        r = rows[(M, K, N)]
        for key in keys:
            out[key] = (None if out[key] is None or r[key] is None
                        else out[key] + per_layer * r[key])
    by = ("bytes" if out["bytes"] / HBM_BYTES_PER_S >= out["ops"] / peak
          else "operations")
    return {"ms": out["ms"], "plain_ms": out["plain_ms"],
            "bound_ms": out["bound_ms"], "bound_by": by,
            "library_ms": out["library_ms"]}


def ptxas_report(log: str, entry: str):
    """{mangled kernel name: (registers, spill bytes, shared-memory bytes)}
    from nvcc's ``-Xptxas -v`` output, for every entry function whose name
    holds `entry`."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if entry in m.group(1) else None
            continue
        if name is None:
            continue
        regs, spill, smem = out.get(name, (0, 0, 0))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            smem = int(sm.group(1)) if sm else 0
        out[name] = (regs, spill, smem)
    return out


#: the rows the W4A16 kernel is checked and timed at: decode (split K),
#: the prefill buckets 32 and 128, the ragged budget and the largest bucket
W4A16_ROWS = (1, MAX_BATCH, 32, BUDGET, 128, PROMPT_BUCKET)


def check_w4a16(torch, timer):
    """The W4A16 kernel against its plain version at every main-path (K, N)
    and every M of W4A16_ROWS, per-channel and grouped (G = 128: K = 896
    pads to 1024, so the high plane carries a group of zeros), on bf16 and
    f32 activations.  M <= 16 runs the split-K kernel and its reduce (each
    shape's plan and load width printed), M > 16 the kernel
    `prefill_plan` picks (printed per shape: the tensor cores for bf16 x,
    FFMA for f32 x); two calls must give the same bits at M = MAX_BATCH,
    BUDGET and PROMPT_BUCKET.  The tensor-core kernel's ptxas registers,
    spill and shared memory are printed.  Timed in bf16, the serving
    path's type; the yardstick is torch.matmul of the bf16 activations with
    a pre-dequantized bf16 weight.  The result's top level is the M <= 16
    path at M = MAX_BATCH, grouped; `m_le16` and `m_gt16` hold each path's
    row (M = MAX_BATCH and M = PROMPT_BUCKET, grouped and per channel);
    `m_gt16` also holds the layer sums at the other prefill rows."""
    from repro_torch.core.quant import group_quantize, pack_int4
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import w4a16_matmul
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped
    from repro_torch.kernels.w4a16_matmul import (
        SPLITK_MAX_M, prefill_plan, splitk_plan, w4a16_matmul_cuda,
        w4a16_matmul_plain)

    ptxas = ptxas_report(_build.build_all(["w4a16_matmul"])["w4a16_matmul"][1],
                         "w4a16_mma_kernel")
    if not ptxas:
        fail("w4a16: no ptxas report of w4a16_mma_kernel in the build log")
    for name, (regs, spill, smem) in sorted(ptxas.items()):
        say(f"ptxas {name}: {regs} registers, {spill} bytes spill, "
            f"{smem} bytes smem")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = {"channel": {}, "g128": {}}
    worst_abs = worst_rel = 0.0
    for (K, N), _ in GEMM_SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        for form, G in (("channel", K), ("g128", 128)):
            w_q, w_scale = group_quantize(w, G)
            w_km = nmajor_to_kmajor_grouped(pack_int4(w_q), w_scale)
            w_deq = (w_q.float().reshape(K // min(G, K), -1, N)
                     * w_scale.reshape(-1, 1, N)).reshape(K, N)
            w_bf = w_deq.to(torch.bfloat16)
            g = G if w_scale.ndim == 3 else 0
            for M in W4A16_ROWS:
                x32 = torch.randn((M, K), generator=gen, device="cuda")
                if M <= SPLITK_MAX_M:
                    p = splitk_plan(M, N, w_km.shape[0], g,
                                    w_km.data_ptr() % 16 == 0)
                    path = (f"split K, {p.vec}-byte loads, {p.splits} splits "
                            f"of {p.rows} packed rows, {p.bn} columns x "
                            f"{p.mt} rows a CTA, {p.ctas} CTAs")
                else:
                    q = prefill_plan(M, K, N, w_km.shape[0], g, True,
                                     x32.data_ptr() % 16 == 0,
                                     w_km.data_ptr() % 16 == 0)
                    q32 = prefill_plan(M, K, N, w_km.shape[0], g, False)
                    what = {"mma": "tensor cores (w4a16_mma_kernel)",
                            "ffma": "FFMA (w4a16_kernel)"}
                    path = (f"bf16 x: {what[q.kernel]}, {q.bm} x 64 CTA "
                            f"tiles, {q.x_vec}-byte x / {q.w_vec}-byte weight "
                            f"loads; f32 x: {what[q32.kernel]}")
                say(f"w4a16 {form:7s} M={M:4d} K={K:5d} N={N:5d}: {path}")
                for dt in ("bfloat16", "float32"):
                    x = x32.to(getattr(torch, dt))
                    got = w4a16_matmul_cuda(x, w_km, w_scale, G)
                    want = w4a16_matmul_plain(x, w_km, w_scale, G)
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, err / scale)
                    if not err <= W4A16_RTOL * scale:
                        fail(f"w4a16_matmul {form} {dt} M={M} K={K} N={N}: "
                             f"max |diff| {err} > {W4A16_RTOL} x {scale}")
                    if M in (MAX_BATCH, BUDGET, PROMPT_BUCKET) \
                            and not torch.equal(got, w4a16_matmul_cuda(
                                x, w_km, w_scale, G)):
                        fail(f"w4a16_matmul {form} {dt} M={M} K={K} N={N}: "
                             "two calls on the same inputs differ")
                    if dt == "float32":
                        continue
                    n_bytes = (x.numel() * x.element_size() + w_km.numel()
                               + w_scale.numel() * 4 + M * N * 4)
                    n_ops = 2.0 * M * K * N
                    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
                    t = timer.ms(lambda: w4a16_matmul_cuda(x, w_km, w_scale,
                                                           G))
                    tp = timer.ms(lambda: w4a16_matmul_plain(
                        x, w_km, w_scale, G), reps=5)
                    lib = timer.ms(lambda: torch.matmul(x, w_bf))
                    say(f"w4a16 {form:7s} M={M:4d} K={K:5d} N={N:5d}: max "
                        f"|diff| {err:.3g} (bf16; f32 checked too); kernel "
                        f"{t:.4f} ms, plain {tp:.4f} ms, bound {b_ms:.5f} ms "
                        f"({b_by}), bf16 matmul {lib:.4f}")
                    rows[form][(M, K, N)] = {
                        "ms": t, "plain_ms": tp, "bound_ms": b_ms,
                        "library_ms": lib, "bytes": n_bytes, "ops": n_ops}
    say(f"w4a16: two calls bit-equal at M={MAX_BATCH}, {BUDGET} and "
        f"{PROMPT_BUCKET}, every shape, both forms and activation types")
    # the public entry point repacks a serialized weight the same way
    x = torch.randn((3, 896), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, w_scale = group_quantize(torch.randn((896, 64), generator=gen,
                                              device="cuda"), 128)
    if not torch.equal(w4a16_matmul(x, pack_int4(w_q), w_scale, 128),
                       w4a16_matmul_cuda(x, nmajor_to_kmajor_grouped(
                           pack_int4(w_q), w_scale), w_scale, 128)):
        fail("ops.w4a16_matmul differs from the kernel on its repacked "
             "weight")
    peak = BF16_OPS_PER_S
    paths = {}
    for path, M, what in (("m_le16", MAX_BATCH, "split K"),
                          ("m_gt16", PROMPT_BUCKET, "tensor cores")):
        paths[path] = {
            "shape": f"one layer's 7 projections at M={M}, grouped G=128, "
                     f"bf16 x ({what}; per channel under 'channel')",
            **_layer_sum(rows["g128"], M, peak),
            "channel": _layer_sum(rows["channel"], M, peak)}
    for M in W4A16_ROWS:
        if SPLITK_MAX_M < M < PROMPT_BUCKET:
            paths["m_gt16"][f"at_m{M}"] = {
                form: _layer_sum(rows[form], M, peak)
                for form in ("g128", "channel")}
    paths["m_gt16"]["ptxas"] = {
        name: {"registers": r, "spill_bytes": sp, "smem_bytes": sm}
        for name, (r, sp, sm) in sorted(ptxas.items())}
    top = {k: v for k, v in paths["m_le16"].items() if k != "channel"}
    return {**top, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            **paths}


#: the rows the table-lookup and unfused W4A4 kernels are checked and timed
#: at: decode rows, the path boundary (M = 16 / 17), the prefill buckets 32
#: and 128, the ragged budget and the largest prompt bucket
LUT4_ROWS = (1, MAX_BATCH, 16, 17, 32, BUDGET, 128, PROMPT_BUCKET)
#: instructions that would compute a product instead of reading it
LUT4_FORBIDDEN = ("IDP", "IMMA", "HMMA")
#: the register lookup's inner loop: 11 instructions for 8 products (two
#: planes' 2 PRMT + 1 LOP3 for 4 products each, one add, two PRMT and two
#: adds to widen), at the 32-bit integer rate of compute capability 9.0,
#: 64 a clock per SM (CUDA C++ Programming Guide, arithmetic instructions)
LUT4_INSTR_PER_PRODUCT = 11 / 8
INT_OPS_PER_CLOCK_SM = 64
SMS = 132


def lut4_method_floor_ms(products: float) -> float:
    """The lookup method's own floor: products x instructions a product
    over the card's integer instruction rate at its highest SM clock
    (nvidia-smi clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    rate = INT_OPS_PER_CLOCK_SM * SMS * mhz * 1e6
    return products * LUT4_INSTR_PER_PRODUCT / rate * 1e3


def sass_functions(library: str, entry: str):
    """{kernel name: SASS} of every function of a built library whose name
    holds `entry`, from ``cuobjdump -sass``; fails if there is none."""
    import os
    import re

    from repro_torch.kernels import _build

    _build.build_all([library])
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(library))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"{library}: cuobjdump -sass failed: {sass.stderr[-2000:]}")
    out = {}
    for body in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        name = body.split("\n", 1)[0].strip()
        if entry in name:
            out[name] = body
    if not out:
        fail(f"{library}: cuobjdump -sass shows no {entry} kernel")
    return out


def lut4_sass_gate():
    """The method gate: ``cuobjdump -sass`` of the built table-lookup
    library; every ``lut4_`` kernel must read its products, so none may hold
    an IDP (dp4a), IMMA or HMMA instruction.  Returns the kernels checked."""
    import re

    kernels = sass_functions("lut4_matmul", "lut4_")
    for name, body in kernels.items():
        bad = sorted({op for op in LUT4_FORBIDDEN
                      if re.search(rf"\b{op}(\.|\s)", body)})
        if bad:
            fail(f"lut4: kernel {name} holds {bad}: a product is computed, "
                 "not read from the table")
    say(f"lut4: SASS of {len(kernels)} lut4_ kernels holds no "
        f"{'/'.join(LUT4_FORBIDDEN)}: every product is a table read")
    return len(kernels)


def check_lut4_int4(torch, timer):
    """The table-lookup kernel and the unfused W4A4 kernel against their
    plain version (exact integer dot) and against each other, bit for bit,
    at every main-path (K, N) and every M of LUT4_ROWS (each shape's
    `lut4_plan` printed), and each two calls bit-equal at M = 8, 64 and
    256.
    The ptxas registers and spill of every lut4 kernel, the SASS method
    gate, and the method's floor (printed only: it is computed, not
    measured).  Yardsticks:
    torch._int_mm on int8 operands where M > 16 (its minimum); at M <= 16
    torch.matmul in float32 on the int values (one call, exact while
    |acc| < 2^24; TF32 is off)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                                 int4_matmul_plain)
    from repro_torch.kernels.lut4_matmul import lut4_matmul_cuda, lut4_plan
    from repro_torch.kernels.packing import pack_kmajor

    ptxas = ptxas_report(_build.build_all(["lut4_matmul"])["lut4_matmul"][1],
                         "lut4_")
    if not ptxas:
        fail("lut4: no ptxas report of a lut4_ kernel in the build log")
    for name, (regs, spill, smem) in sorted(ptxas.items()):
        say(f"ptxas {name}: {regs} registers, {spill} bytes spill, "
            f"{smem} bytes smem")
    n_sass = lut4_sass_gate()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = {"lut4": {}, "int4": {}}
    for M in LUT4_ROWS:
        for (K, N), _ in GEMM_SHAPES:
            a_q = torch.randint(-8, 8, (M, K), generator=gen, device="cuda",
                                dtype=torch.int8)
            a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.1 + 1e-3
            w_q = torch.randint(-8, 8, (K, N), generator=gen, device="cuda",
                                dtype=torch.int8)
            w_km = pack_kmajor(w_q).contiguous()
            w_s = (torch.rand((1, N), generator=gen, device="cuda") * 0.01
                   + 1e-3)
            p = lut4_plan(M, K, N, w_km.shape[0],
                          w_km.data_ptr() % 16 == 0)
            say(f"lut4 plan M={M:4d} K={K:5d} N={N:5d}: "
                f"{p.bm} x 128 CTA tiles, {p.vec}-byte weight loads, "
                f"{p.splits} splits of {p.rows} packed rows, {p.ctas} CTAs"
                + (", then the reduce" if p.splits > 1 else ""))
            want = int4_matmul_plain(a_q, a_s, w_km, w_s)
            got_lut = lut4_matmul_cuda(a_q, a_s, w_km, w_s)
            got_int = int4_matmul_cuda(a_q, a_s, w_km, w_s)
            for name, got in (("lut4_matmul", got_lut),
                              ("int4_matmul", got_int)):
                if not torch.equal(got, want):
                    fail(f"{name} M={M} K={K} N={N}: kernel differs from the "
                         f"plain version (max |diff| "
                         f"{(got - want).abs().max().item()})")
            if not torch.equal(got_lut, got_int):
                fail(f"lut4_matmul M={M} K={K} N={N}: differs from the "
                     "unfused W4A4 kernel")
            if M in (MAX_BATCH, BUDGET, PROMPT_BUCKET):
                for name, got, fn in (("lut4_matmul", got_lut,
                                       lut4_matmul_cuda),
                                      ("int4_matmul", got_int,
                                       int4_matmul_cuda)):
                    if not torch.equal(got, fn(a_q, a_s, w_km, w_s)):
                        fail(f"{name} M={M} K={K} N={N}: two calls on the "
                             "same inputs differ")
            n_bytes = M * K + M * 4 + w_km.numel() + N * 4 + M * N * 4
            n_ops = 2.0 * M * K * N
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
            t_lut = timer.ms(lambda: lut4_matmul_cuda(a_q, a_s, w_km, w_s))
            t_int = timer.ms(lambda: int4_matmul_cuda(a_q, a_s, w_km, w_s))
            tp = timer.ms(lambda: int4_matmul_plain(a_q, a_s, w_km, w_s),
                          reps=5)
            lib = _int_yardstick_ms(torch, timer, a_q, w_q)
            say(f"lut4/int4 M={M:4d} K={K:5d} N={N:5d}: both bit-exact and "
                f"equal; lut4 {t_lut:.4f} ms, int4 {t_int:.4f} ms, plain "
                f"{tp:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), "
                + (f"_int_mm {lib:.4f}" if M > 16 else
                   f"f32 matmul (exact, |acc| < 2^24) {lib:.4f}"))
            base = {"plain_ms": tp, "bound_ms": b_ms, "library_ms": lib,
                    "bytes": n_bytes, "ops": n_ops}
            for name, t in (("lut4", t_lut), ("int4", t_int)):
                rows[name][(M, K, N)] = {"ms": t, **base}
    say(f"lut4, int4: two calls bit-equal at M={MAX_BATCH}, {BUDGET} and "
        f"{PROMPT_BUCKET}, every shape")
    out = {}
    for name in ("lut4", "int4"):
        out[name] = {"shape": f"one layer's 7 projections at "
                              f"M={PROMPT_BUCKET} (M={MAX_BATCH} under "
                              f"'at_decode', M={BUDGET} under 'at_budget'; "
                              "yardstick _int_mm, at M <= 16 a float32 "
                              "torch.matmul on the int values)",
                     "max_abs_err": 0.0,
                     **_layer_sum(rows[name], PROMPT_BUCKET, INT8_OPS_PER_S),
                     "at_decode": _layer_sum(rows[name], MAX_BATCH,
                                             INT8_OPS_PER_S),
                     "at_budget": _layer_sum(rows[name], BUDGET,
                                             INT8_OPS_PER_S)}
    floor = {f"m{M}": lut4_method_floor_ms(M * sum(n * K * N for (K, N), n
                                                    in GEMM_SHAPES))
             for M in (MAX_BATCH, BUDGET, PROMPT_BUCKET)}
    out["lut4"]["per_shape_ms"] = {
        f"M={M} K={K} N={N}": r["ms"]
        for (M, K, N), r in sorted(rows["lut4"].items())}
    out["lut4"]["ptxas"] = {
        name: {"registers": r, "spill_bytes": sp, "smem_bytes": sm}
        for name, (r, sp, sm) in sorted(ptxas.items())}
    out["lut4"]["sass_kernels_checked"] = n_sass
    say("lut4: one layer's method floor, computed, not measured (products "
        f"x 11/8 instructions over 64 a clock per SM), ms {json.dumps(floor)}")
    return out["lut4"], out["int4"]


#: the elementwise table product's timed size and its odd cases: a tail
#: past the last whole 16-element vector, and operands off 16-byte
#: alignment (a[1:] and b[1:] share their offset, out does not)
MUL4_N = 1 << 20
MUL4_TAIL_N = (1 << 20) + 7


def check_mul4(torch, timer):
    """The elementwise table kernel, both strategies, on all 256 int4 pairs,
    on a 1M-element tensor, on a tail (n = 2^20 + 7) and on operands off
    16-byte alignment: exact.  Times the kernel, the plain version,
    torch.mul on the int8 tensors (every product fits int8) and the floor
    (an empty launch of the same grid)."""
    from repro_torch.kernels.lut_mul4 import (
        lut_mul4_cuda, lut_mul4_floor_cuda, lut_mul4_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    vals = torch.arange(-8, 8, dtype=torch.int8, device="cuda")
    pairs = (vals.repeat_interleave(16), vals.repeat(16))
    n = MUL4_N

    def rand(size):
        return torch.randint(-8, 8, (size,), generator=gen, device="cuda",
                             dtype=torch.int8)

    big = (rand(n), rand(n))
    tail = (rand(MUL4_TAIL_N), rand(MUL4_TAIL_N))
    cases = {"all 256 pairs": pairs, "1M elements": big,
             f"n = {MUL4_TAIL_N}": tail,
             "a[1:], b[1:]": (tail[0][1:], tail[1][1:]),
             "a[1:], b aligned": (tail[0][1:], tail[1][:-1]),
             "a[3:1000]": (tail[0][3:1000], tail[1][5:1002])}
    exact = (pairs[0].int() * pairs[1].int()).to(torch.int8)
    for strategy in ("onehot", "take"):
        for what, (a, b) in cases.items():
            got = lut_mul4_cuda(a, b, strategy)
            if not torch.equal(got, lut_mul4_plain(a, b, strategy)):
                fail(f"lut_mul4 {strategy} on {what}: differs from the plain "
                     "version")
        if not torch.equal(lut_mul4_cuda(*pairs, strategy), exact):
            fail(f"lut_mul4 {strategy}: a product of the 256 pairs is wrong")
    b_ms, b_by = bound_ms(3.0 * n, float(n), INT8_OPS_PER_S)
    t = timer.ms(lambda: lut_mul4_cuda(*big))
    tp = timer.ms(lambda: lut_mul4_plain(*big), reps=5)
    lib = timer.ms(lambda: torch.mul(*big))
    out = torch.empty_like(big[0])
    floor = timer.ms(lambda: lut_mul4_floor_cuda(*big, out))
    t_odd = timer.ms(lambda: lut_mul4_cuda(tail[0][1:], tail[1][1:]))
    say(f"lut_mul4 n={n} (both strategies; all 256 pairs, a tail, unaligned "
        f"operands): exact; kernel {t:.4f} ms, plain {tp:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}), torch.mul {lib:.4f} ms, floor (empty "
        f"launch, same grid) {floor:.4f} ms; a[1:] * b[1:] at "
        f"{MUL4_TAIL_N - 1} elements (a 15-byte head, then 16-byte "
        f"vectors) {t_odd:.4f} ms")
    return {"shape": f"{n} int8 elements", "max_abs_err": 0.0, "ms": t,
            "plain_ms": tp, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "floor_ms": floor, "unaligned_ms": t_odd}


def _pools(torch, gen, P, ps):
    """{pool dtype: (k, v, k_scale, v_scale)}: one set of seeded normal K/V
    values as a bf16 pool and quantized per (token, head) into int8 and
    int4 pools, as the serving writes store them."""
    from repro_torch.models.attention import quantize_kv

    vals = [torch.randn((P, ps, KV, HD), generator=gen, device="cuda")
            for _ in range(2)]
    out = {"bfloat16": (vals[0].to(torch.bfloat16),
                        vals[1].to(torch.bfloat16), None, None)}
    for dt in ("int8", "int4"):
        (k, ks), (v, vs) = (quantize_kv(x, int4=dt == "int4") for x in vals)
        out[dt] = (k, v, ks, vs)
    return out


def _table(torch, gen, rows, P, pps, last_pos):
    """Block-table rows [rows, pps] on distinct random pages covering each
    row's positions 0..last_pos[r]; the rest sentinel (== P)."""
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    tbl = torch.full((rows, pps), P, dtype=torch.int32, device="cuda")
    used = 0
    for b, lp in enumerate(last_pos):
        n = -(-(lp + 1) // PAGE_SIZE) if lp >= 0 else 0
        tbl[b, :n] = perm[used:used + n]
        used += n
    return tbl


def _gather_dense(torch, pool, scale, tbl, P):
    """Yardstick helper: each table row's pages as a dense bf16
    [rows, pps * ps, KV, HD], dequantized like the reference's gather."""
    from repro_torch.models.attention import dequantize_kv

    idx = tbl.clamp(max=P - 1).long()
    g = pool[idx]                                   # [rows, pps, ps, KV, w]
    if scale is not None:
        g = dequantize_kv(g, scale[idx])
    return g.reshape(tbl.shape[0], -1, KV, HD)


def _sdpa(torch, q, kf, vf, mask):
    """q [rows, H, HD] against dense kf/vf [rows, S, KV, HD] with a
    [rows, S] mask, GQA expanded: the yardstick's one library call."""
    G = H // KV
    kt = kf.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = vf.repeat_interleave(G, dim=2).transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask[:, None, None, :])


#: the paged decode check's live contexts: a serving batch with two idle
#: rows (-1), a page boundary and the last token of the first split
DECODE_LAST = [287, 15, -1, 140, 16, 319, -1, 63]
#: pool pages, and the table's width in pages (max_ctx 512)
DECODE_PAGES, DECODE_PPS = 256, 512 // PAGE_SIZE


def decode_ptxas(lib: str, entry: str):
    """Print the ptxas registers, spill and static shared memory of every
    `entry` kernel of library `lib`; fail on spill or a missing report."""
    from repro_torch.kernels import _build

    report = ptxas_report(_build.build_all([lib])[lib][1], entry)
    if not report:
        fail(f"{lib}: no ptxas report of {entry} in the build log")
    for name, (regs, spill, smem) in sorted(report.items()):
        say(f"{lib} ptxas {name}: {regs} registers, {spill} bytes spill, "
            f"{smem} bytes static smem")
        if spill:
            fail(f"{lib}: {name} spills {spill} bytes")
    return {name: {"registers": r, "spill_bytes": sp, "smem": sm}
            for name, (r, sp, sm) in sorted(report.items())}


def decode_inputs(torch, gen):
    """The paged decode check's operands at the serving shape: q [8, H, HD]
    bf16, a table of DECODE_PPS pages a row over DECODE_PAGES pages, the
    rows' last positions, and the pools of `_pools`."""
    B = len(DECODE_LAST)
    q = torch.randn((B, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    tbl = _table(torch, gen, B, DECODE_PAGES, DECODE_PPS, DECODE_LAST)
    lp = torch.tensor(DECODE_LAST, dtype=torch.int32, device="cuda")
    return q, tbl, lp, _pools(torch, gen, DECODE_PAGES, PAGE_SIZE)


def check_decode(torch, timer):
    """The paged decode kernel against its plain version on bf16, int8 and
    int4 pools at the serving shape, with and without a window: within
    ATTN_ATOL, idle rows exactly zero, two calls bit-equal.  Prints the
    split plan, the ptxas report of both decode kernels (fails on spill),
    and times the kernel, the plain version, gather + SDPA and the floor
    (an empty launch of the same grid and cluster)."""
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        decode_floor_cuda, decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)

    ptxas = decode_ptxas("paged_decode", "paged_decode_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ps, P, pps = PAGE_SIZE, DECODE_PAGES, DECODE_PPS
    last_pos = DECODE_LAST
    B = len(last_pos)
    q, tbl, lp, pools = decode_inputs(torch, gen)
    plan = decode_plan(pps * ps, ps)
    say(f"paged decode plan (table {pps * ps} tokens, ps {ps}): {plan}, grid "
        f"({B}, {KV}, {plan.nsplit}) = {B * KV * plan.nsplit} CTAs")
    pp = max(1, attn_default_blocks("attn.paged_decode", B, pps * ps, H * HD,
                                    group_size=ps)["bk"] // ps)
    idle = [b for b, x in enumerate(last_pos) if x < 0]
    n_tok = sum(x + 1 for x in last_pos if x >= 0)
    n_pages = sum(-(-(x + 1) // ps) for x in last_pos if x >= 0)
    S = pps * ps
    mask = torch.arange(S, device="cuda")[None, :] <= lp[:, None]
    dev = torch.device("cuda")
    floor = timer.ms(lambda: decode_floor_cuda(B, KV, ps, pps, dev))
    res = {}
    for dt in POOL_DTYPES:
        k, v, ks, vs = pools[dt]
        errs = []
        for window in (0, 40):
            got = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                              window=window)
            again = paged_decode_attention_cuda(q, k, v, tbl, lp, ks, vs,
                                                window=window)
            want = paged_decode_attention_plain(q, k, v, tbl, lp, ks, vs,
                                                window=window, pp=pp)
            err = (got.float() - want.float()).abs().max().item()
            if err > ATTN_ATOL or not torch.all(got[idle] == 0):
                fail(f"paged_decode_attention ({dt} pool, window {window}): "
                     f"max |diff| {err} > {ATTN_ATOL} or an idle row is not "
                     "zero")
            if not torch.equal(got, again):
                fail(f"paged_decode_attention ({dt} pool, window {window}): "
                     "two calls differ")
            errs.append(err)
        # q of the live rows in, every row out, the live pages' K/V, scales
        # and table entries, and last_pos: idle rows only write zeros
        elem, sbytes = POOL_BYTES[dt]
        n_bytes = ((B - len(idle)) * H * HD * 2 + B * H * HD * 2
                   + 2 * n_tok * KV * (HD * elem + sbytes)
                   + n_pages * 4 + B * 4)
        n_ops = 4.0 * H * HD * n_tok
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: paged_decode_attention_cuda(q, k, v, tbl, lp, ks,
                                                         vs))
        tp = timer.ms(lambda: paged_decode_attention_plain(
            q, k, v, tbl, lp, ks, vs, pp=pp), reps=5)
        lib = timer.ms(lambda: _sdpa(
            torch, q, _gather_dense(torch, k, ks, tbl, P),
            _gather_dense(torch, v, vs, tbl, P), mask))
        say(f"paged decode {dt} pool B={B} H={H} KV={KV} hd={HD} ps={ps}: "
            f"max |diff| {errs[0]:.3g} (window {errs[1]:.3g}), two calls "
            f"bit-equal; kernel {t:.4f} ms, plain {tp:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), gather+SDPA {lib:.4f} ms, floor "
            f"{floor:.4f} ms")
        res[dt] = {"max_abs_err": max(errs), "ms": t, "plain_ms": tp,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return {"shape": f"B={B}, H={H}, KV={KV}, hd={HD}, ps={ps}, "
                     f"{n_tok} live tokens, bf16 pool (int8/int4 under "
                     f"'pools')",
            **res["bfloat16"],
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "floor_ms": floor,
            "ptxas": ptxas,
            "pools": {dt: res[dt] for dt in ("int8", "int4")}}


def _ragged_pack(torch):
    """The ragged step's pack at the serving shape: BUDGET = 64 rows, 8
    decode rows (slots 0-7, one per running request), one 48-row prefill
    chunk (slot 8: positions 160..207 of a 256-token prompt) and 8 padding
    rows.  Returns (slot, pos, last positions per table row)."""
    dec = [287, 15, 140, 16, 319, 63, 511, 200]
    chunk = list(range(160, 208))
    n_pad = BUDGET - len(dec) - len(chunk)
    slot = list(range(len(dec))) + [len(dec)] * len(chunk) + [-1] * n_pad
    pos = dec + chunk + [-1] * n_pad
    as_t = (lambda x: torch.tensor(x, dtype=torch.int32, device="cuda"))
    return as_t(slot), as_t(pos), dec + [chunk[-1]]


def check_ragged(torch, timer):
    """The ragged kernel against its plain version on the serving step's
    pack (bf16, int8 and int4 pools): within ATTN_ATOL, padding rows
    exactly zero, two calls bit-equal, and a decode-only pack bit-equal to
    the paged decode kernel.  Prints the split plan and the ptxas report
    (fails on spill); times the kernel, the plain version, gather + SDPA
    and the floor (an empty launch of the same grid and cluster)."""
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        decode_floor_cuda, decode_plan, paged_decode_attention_cuda)
    from repro_torch.kernels.ragged_attention import (
        ragged_decode_attention_cuda, ragged_decode_attention_plain)

    ptxas = decode_ptxas("ragged_decode", "ragged_decode_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    ps = PAGE_SIZE
    P, pps = 320, 512 // PAGE_SIZE
    slot, pos, row_last = _ragged_pack(torch)
    T = slot.shape[0]
    plan = decode_plan(pps * ps, ps)
    say(f"ragged plan (table {pps * ps} tokens, ps {ps}): {plan}, grid "
        f"({T}, {KV}, {plan.nsplit}) = {T * KV * plan.nsplit} CTAs")
    floor = timer.ms(lambda: decode_floor_cuda(T, KV, ps, pps,
                                               torch.device("cuda")))
    tbl = _table(torch, gen, len(row_last), P, pps, row_last)
    q = torch.randn((T, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    pools = _pools(torch, gen, P, ps)
    pp = max(1, attn_default_blocks("attn.ragged", T, pps * ps, H * HD,
                                    group_size=ps)["bk"] // ps)
    pad = (slot < 0) | (pos < 0)
    n_dec = len(row_last) - 1
    live_tok = sum(x + 1 for x in row_last)        # each live page once
    n_pages = sum(-(-(x + 1) // ps) for x in row_last)
    n_live = int((~pad).sum().item())
    pairs = int((pos[~pad] + 1).sum().item())      # (query, key) pairs
    S = pps * ps
    rows = tbl[slot.clamp(min=0).long()]
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])
    mask[pad, 0] = True                            # keep SDPA finite
    res = {}
    for dt in POOL_DTYPES:
        k, v, ks, vs = pools[dt]
        got = ragged_decode_attention_cuda(q, k, v, tbl, slot, pos, ks, vs)
        again = ragged_decode_attention_cuda(q, k, v, tbl, slot, pos, ks, vs)
        want = ragged_decode_attention_plain(q, k, v, tbl, slot, pos, ks, vs,
                                             pp=pp)
        err = (got.float() - want.float()).abs().max().item()
        if err > ATTN_ATOL or not torch.all(got[pad] == 0):
            fail(f"ragged_decode_attention ({dt} pool): max |diff| {err} > "
                 f"{ATTN_ATOL} or a padding row is not exactly zero")
        if not torch.equal(got, again):
            fail(f"ragged_decode_attention ({dt} pool): two calls differ")
        # a decode-only pack: the paged decode kernel's output, bit for bit
        dec_rows = ragged_decode_attention_cuda(
            q[:n_dec].contiguous(), k, v, tbl, slot[:n_dec].contiguous(),
            pos[:n_dec].contiguous(), ks, vs)
        paged = paged_decode_attention_cuda(
            q[:n_dec].contiguous(), k, v, tbl[:n_dec].contiguous(),
            pos[:n_dec].contiguous(), ks, vs)
        if not torch.equal(dec_rows, paged):
            fail(f"ragged_decode_attention ({dt} pool): a decode-only pack "
                 "differs from the paged decode kernel's output (max |diff| "
                 f"{(dec_rows.float() - paged.float()).abs().max().item()})")
        # q of the live rows in, every row out, each live page's K/V, scales
        # and table entry once, and slot/pos: padding rows only write zeros
        elem, sbytes = POOL_BYTES[dt]
        n_bytes = (n_live * H * HD * 2 + T * H * HD * 2
                   + 2 * live_tok * KV * (HD * elem + sbytes)
                   + n_pages * 4 + T * 4 * 2)
        n_ops = 4.0 * H * HD * pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: ragged_decode_attention_cuda(q, k, v, tbl, slot,
                                                          pos, ks, vs))
        tp = timer.ms(lambda: ragged_decode_attention_plain(
            q, k, v, tbl, slot, pos, ks, vs, pp=pp), reps=5)
        lib = timer.ms(lambda: _sdpa(
            torch, q, _gather_dense(torch, k, ks, rows, P),
            _gather_dense(torch, v, vs, rows, P), mask))
        say(f"ragged {dt} pool T={T} ({n_dec} decode rows, one "
            f"{int((slot == n_dec).sum())}-row chunk, {int(pad.sum())} "
            f"padding) H={H} KV={KV} hd={HD} ps={ps}: max |diff| {err:.3g}, "
            f"two calls bit-equal, decode-only pack == paged decode; kernel "
            f"{t:.4f} ms, plain {tp:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"gather+SDPA {lib:.4f} ms, floor {floor:.4f} ms")
        res[dt] = {"max_abs_err": err, "ms": t, "plain_ms": tp,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return {"shape": f"T={T}: {n_dec} decode rows, a 48-row prefill chunk, "
                     f"{int(pad.sum())} padding; H={H}, KV={KV}, hd={HD}, "
                     f"ps={ps}, int8 pool (bf16/int4 under 'pools')",
            **res["int8"],
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "floor_ms": floor,
            "ptxas": ptxas,
            "pools": {dt: res[dt] for dt in ("bfloat16", "int4")}}


#: flash prefill's timed shapes: (Sq, Skv, real queries, prefix hit, heads,
#: KV heads, head dim).  The fresh prefills are the Poisson trace's prompt
#: buckets (32, 128, 256 holding 32, 96 and 200 real tokens, left-padded);
#: the tail is 64 suffix queries over a gathered 512-slot cache after a
#: 160-token prefix hit; hd128 is qwen3-4b's attention (32 heads over 8 KV
#: heads) on the 256 bucket
FLASH_CASES = {"fresh32": (32, 32, 32, 0, H, KV, HD),
               "fresh128": (128, 128, 96, 0, H, KV, HD),
               "fresh256": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, H, KV, HD),
               "tail": (64, 512, 50, 160, H, KV, HD),
               "hd128": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, 32, 8, 128)}
#: the window every shape is also checked at
FLASH_WINDOW = 48


def flash_sass_gate():
    """The method gate: every ``flash_prefill_kernel`` instantiation's SASS
    must hold HMMA (QK and PV on the tensor cores).  Returns the kernels
    checked."""
    import re

    kernels = sass_functions("flash_prefill", "flash_prefill_kernel")
    for name, body in sorted(kernels.items()):
        n = len(re.findall(r"\bHMMA\.", body))
        if not n:
            fail(f"flash: kernel {name} holds no HMMA: QK and PV are not on "
                 "the tensor cores")
        say(f"flash: SASS of {name} holds {n} HMMA")
    return len(kernels)


def w4a4_sass_gate():
    """The method gate: every ``w4a4_`` kernel's SASS must hold IMMA (the
    int8 tensor cores).  Returns the kernels checked."""
    import re

    kernels = sass_functions("int4_matmul", "w4a4_")
    for name, body in sorted(kernels.items()):
        n = len(re.findall(r"\bIMMA\.", body))
        if not n:
            fail(f"w4a4: kernel {name} holds no IMMA: the dot is not on the "
                 "tensor cores")
        say(f"w4a4: SASS of {name} holds {n} IMMA")
    return len(kernels)


def _flash_inputs(torch, gen, Sq, Skv, n_real, hit, nh, nkv, hd):
    """Seeded q/k/v and positions of one FLASH_CASES shape (B = 1): the
    queries are the last n_real of Sq (left padding -1) at positions
    hit, hit + 1, ...; the keys are the cache's slots, live up to the last
    query's position."""
    q = torch.randn((1, Sq, nh, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((1, Skv, nkv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((1, Skv, nkv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    base = torch.arange(Sq, device="cuda") - (Sq - n_real)
    qpos = torch.where(base >= 0, base + hit, -1).to(torch.int32)[None]
    if Skv == Sq and not hit:
        kpos = qpos
    else:
        j = torch.arange(Skv, device="cuda")
        kpos = torch.where(j <= hit + n_real - 1, j, -1).to(
            torch.int32)[None]
    return q, k, v, qpos, kpos


def check_flash(torch, timer):
    """Flash prefill against its plain version at every FLASH_CASES shape,
    with and without a window: within ATTN_ATOL, padding rows exactly zero,
    two calls bit-equal.  Prints each shape's `flash_plan`, the ptxas
    registers, spill and static shared memory of each instantiation, and
    runs the SASS gate (HMMA in every flash kernel).  Times the kernel, the
    plain version and SDPA (GQA expanded) at every shape.  The result's
    top level is fresh256, the main path's largest prefill; `shapes` holds
    every shape's row."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        flash_plan, flash_prefill_cuda, flash_prefill_plain)

    ptxas = ptxas_report(
        _build.build_all(["flash_prefill"])["flash_prefill"][1],
        "flash_prefill_kernel")
    if not ptxas:
        fail("flash: no ptxas report of flash_prefill_kernel in the build log")
    for name, (regs, spill, smem) in sorted(ptxas.items()):
        say(f"flash ptxas {name}: {regs} registers, {spill} bytes spill, "
            f"{smem} bytes static smem")
    n_sass = flash_sass_gate()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    for case, (Sq, Skv, n_real, hit, nh, nkv, hd) in FLASH_CASES.items():
        q, k, v, qpos, kpos = _flash_inputs(torch, gen, Sq, Skv, n_real, hit,
                                            nh, nkv, hd)
        G = nh // nkv
        plan = flash_plan(1, Sq, Skv, nh, nkv, hd)
        say(f"flash plan {case}: {plan}")
        bk = attn_default_blocks("attn.prefill", Sq, Skv, nh * hd)["bk"]
        pad_rows = qpos[0] < 0
        errs = []
        for window in (0, FLASH_WINDOW):
            got = flash_prefill_cuda(q, k, v, qpos, kpos, window=window)
            again = flash_prefill_cuda(q, k, v, qpos, kpos, window=window)
            want = flash_prefill_plain(q, k, v, qpos, kpos, window=window,
                                       bk=bk)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if err > ATTN_ATOL or not torch.all(got[0, pad_rows] == 0):
                fail(f"flash_prefill ({case}, window {window}): max |diff| "
                     f"{err} > {ATTN_ATOL} or a padding row is not zero")
            if not torch.equal(got, again):
                fail(f"flash_prefill ({case}, window {window}): two calls "
                     "differ")
            errs.append(err)
        qp, kp = qpos[0].long(), kpos[0].long()
        allowed = ((qp[:, None] >= kp[None, :]) & (kp[None, :] >= 0))
        pairs = int((allowed & (qp[:, None] >= 0)).sum().item())
        n_bytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + (Sq + Skv) * 4)
        n_ops = 4.0 * nh * hd * pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: flash_prefill_cuda(q, k, v, qpos, kpos))
        tp = timer.ms(lambda: flash_prefill_plain(q, k, v, qpos, kpos, bk=bk),
                      reps=5)
        F = torch.nn.functional
        # padding queries see no key; give them one so SDPA stays finite
        allowed[:, 0] |= ~allowed.any(dim=1)
        mask = allowed[None, None]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        say(f"flash prefill {case} Sq={Sq} Skv={Skv} H={nh} KV={nkv} "
            f"hd={hd}: max |diff| {errs[0]:.3g} (window {errs[1]:.3g}); "
            f"kernel {t:.4f} ms, plain {tp:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}), SDPA {lib:.4f} ms, {plan.ctas} CTAs of "
            f"{plan.warps} warps")
        out[case] = {"shape": f"{case}: B=1, Sq={Sq}, Skv={Skv}, H={nh}, "
                              f"KV={nkv}, hd={hd}, {n_real} real queries",
                     "max_abs_err": max(errs), "ms": t, "plain_ms": tp,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "ctas": plan.ctas, "warps": plan.warps}
    top = out["fresh256"]
    return {"max_abs_err": max(r["max_abs_err"] for r in out.values()),
            **{key: top[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "sass_kernels_checked": n_sass, "shapes": out}


# ------------------------------------------------------------ phase 4 ----
def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "device"):
        yield tree


#: the W4A16 serve run's plan: pre-packed grouped weight-only int4
W4A16_PLAN = "*=w4a16_packed/g128;lm_head=float"
#: the serve runs of phase 4: name -> (step, KV pool, Runtime quant keywords,
#: the kernels the run must launch, and those it must not: the other
#: path's attention kernels and the other plans' GEMMs)
SERVE_RUNS = {
    "bucketed": ("bucketed", "bfloat16", {"quant_backend": "w4a4_packed"},
                 ("int4_matmul_fused", "flash_prefill",
                  "paged_decode_attention"),
                 ("ragged_decode_attention", "w4a16_matmul", "lut4_matmul")),
    "ragged": ("ragged", "int8", {"quant_backend": "w4a4_packed"},
               ("int4_matmul_fused", "ragged_decode_attention"),
               ("flash_prefill", "paged_decode_attention", "w4a16_matmul",
                "lut4_matmul")),
    "w4a16": ("bucketed", "bfloat16", {"quant_plan": W4A16_PLAN},
              ("w4a16_matmul", "flash_prefill", "paged_decode_attention"),
              ("int4_matmul_fused", "lut4_matmul",
               "ragged_decode_attention")),
    "lut4": ("bucketed", "bfloat16", {"quant_backend": "lut4"},
             ("lut4_matmul", "flash_prefill", "paged_decode_attention"),
             ("int4_matmul_fused", "w4a16_matmul",
              "ragged_decode_attention")),
}
#: the GEMM each serve run's projections go through: 7 launches per layer
#: per forward
RUN_GEMM = {"bucketed": "int4_matmul_fused", "ragged": "int4_matmul_fused",
            "w4a16": "w4a16_matmul", "lut4": "lut4_matmul"}
#: the device kernels behind each GEMM wrapper, by a prefix of their name
#: (the W4A16 wrapper's M <= 16 path and the lut4 wrapper's split calls
#: launch two: split K, then reduce)
GEMM_KERNELS = {"int4_matmul_fused": "w4a4_",
                "w4a16_matmul": "w4a16_", "lut4_matmul": "lut4_"}


def eager_engine(*args, **kwargs):
    """An InferenceEngine on cuda whose steps run eagerly, one launch per
    op, as on the CPU: the run the captured steps are compared with."""
    from unittest import mock

    from repro_torch.serving.engine import InferenceEngine

    with mock.patch.object(InferenceEngine, "_capture_steps",
                           lambda *a: None):
        return InferenceEngine(*args, **kwargs)


def serve_run(torch, params, run: str, trace, prompt_lens, eager=False):
    """Serve `trace` on full-width qwen2-0.5b through InferenceEngine on
    cuda as serve run `run` of SERVE_RUNS, its steps captured (or eager,
    with `eager`); checks every request, the devices of every tensor, the
    launches of the path (counted from 0 just before the run) and, for the
    captured steps, that no shape was captured twice.  Returns (engine,
    launches, stats, tokens by request id)."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.api import run_trace
    from repro_torch.serving.engine import InferenceEngine

    step, cache_dtype, quant, must, must_not = SERVE_RUNS[run]
    cfg = get_config("qwen2-0.5b")
    rt = Runtime(attn_impl="flash", cache_dtype=cache_dtype, **quant)
    sv = ServingConfig(layout="paged", max_batch=MAX_BATCH,
                       page_size=PAGE_SIZE, num_pages=320, max_ctx=512,
                       prefix_cache=True, step=step)
    make = eager_engine if eager else InferenceEngine
    engine = make(cfg, rt, sv, params=params, device="cuda")
    label = f"{run}, {'eager' if eager else 'graphs'}"
    for tree, what in ((engine.params, "parameter"), (engine.caches, "cache")):
        cpu = [t for t in _tensors(tree) if t.device.type != "cuda"]
        if cpu:
            fail(f"serve ({label}): {len(cpu)} {what} tensors are not on the "
                 "card")
    engine.warmup(prompt_lens)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats, finished = run_trace(engine, trace)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    bad = [r.rid for r in finished if r.outcome != "ok"]
    if len(finished) != len(trace) or bad:
        fail(f"serve ({label}): {len(finished)}/{len(trace)} requests "
             f"retired, not ok: {bad}")
    for r in finished:
        if len(r.tokens) != r.max_new or not all(
                0 <= t < cfg.vocab for t in r.tokens):
            fail(f"serve ({label}): request {r.rid} produced {len(r.tokens)} "
                 f"tokens (want {r.max_new}) or a token outside "
                 f"[0, {cfg.vocab})")
    for name in must:
        if launches[name] <= 0:
            fail(f"serve ({label}): kernel {name} was never launched on the "
                 "path")
    for name in must_not:
        if launches[name] != 0:
            fail(f"serve ({label}): {name} launched {launches[name]} times "
                 "on a path that does not run it")
    gemm = RUN_GEMM[run]
    if launches[gemm] % (7 * LAYERS):
        fail(f"serve ({label}): {gemm} launched {launches[gemm]} times, not 7 "
             "per layer per forward")
    budget = (f", token budget {stats['token_budget']}, padding rows "
              f"{stats['padding_tokens_wasted']}" if step == "ragged" else "")
    say(f"serve ({label}: {step}, {cache_dtype} pool, "
        f"{rt.quant_plan or rt.quant_backend}): {len(finished)} requests ok, "
        f"{stats['decode_tokens']} decode tokens in {stats['wall_s']:.2f} s = "
        f"{stats['decode_tok_per_s']:.1f} tok/s; latency p50 "
        f"{stats['latency_p50_s']:.3f} s, p95 {stats['latency_p95_s']:.3f} s; "
        f"ttft p50 {stats['ttft_p50_s']:.3f} s; steps {stats['steps']} "
        f"(mean {stats['wall_s'] / stats['steps'] * 1e3:.1f} ms), preempted "
        f"{stats['requests_preempted']}, prefill tokens "
        f"{stats['prefill_tokens']}{budget}")
    say(f"serve ({label}): kernel launches {json.dumps(launches)}")
    rec = stats["recompiles"]
    say(f"serve ({label}): step shapes compiled {rec['total']} "
        f"{json.dumps(rec['by_fn'])}, in steady state {rec['steady_state']}; "
        "mid-run: " + (", ".join(f"{e['fn']} {e['shape']} at step "
                                 f"{e['step']}" for e in rec["events"]
                                 if e["step"]) or "none"))
    if rec["steady_state"]:
        fail(f"serve ({label}): {rec['steady_state']} steady-state recompiles "
             f"(a step shape captured again): {rec['events']}")
    if not eager:
        graphs = sum(getattr(engine, "_" + n)._cache_size()
                     for n in ("prefill", "prefill_tail", "decode", "ragged")
                     if getattr(engine, "_" + n) is not None)
        if graphs != rec["total"]:
            fail(f"serve ({label}): {graphs} captured graphs, but the "
                 f"sentinel counted {rec['total']} compiles")
    return engine, launches, stats, {r.rid: list(r.tokens) for r in finished}


def phase_serve(torch):
    """The bucketed path (bf16 pool, Poisson trace), then the ragged path
    (int8 pool, mixed trace), on one set of full-width W4A4 weights; then
    the bucketed path on the Poisson trace under the W4A16 plan (pre-packed
    grouped weights) and under lut4 (on-the-fly weights, the same masters),
    whose tokens must equal the W4A4 run's.  Returns the launches of all
    runs, summed."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.serving.api import mixed_trace, poisson_trace
    from repro_torch.serving.engine import build_params

    cfg = get_config("qwen2-0.5b")
    prompt_lens = (32, 96, 160, 256)
    poisson = poisson_trace(8, 0.5, prompt_lens, (16, 32, 64), cfg.vocab,
                            seed=SEED)
    launches, tokens = [], {}
    for runs, quant in ((("bucketed", "ragged"), "w4a4_packed"),
                        (("w4a16",), "w4a16"), (("lut4",), "lut4")):
        t0 = time.perf_counter()
        params = build_params(cfg, Runtime(**SERVE_RUNS[runs[0]][2]),
                              seed=SEED, device="cuda")
        torch.cuda.synchronize()
        say(f"serve: built full-width {cfg.name} ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, vocab {cfg.vocab}) for {quant} in "
            f"{time.perf_counter() - t0:.1f} s")
        for run in runs:
            trace = (mixed_trace(8, prompt_lens, (16, 32), cfg.vocab,
                                 seed=SEED) if run == "ragged" else poisson)
            engine, n, _, tokens[run] = serve_run(torch, params, run, trace,
                                                  prompt_lens)
            launches.append(n)
            prof = {"graphs": profile_steps(torch, engine, cfg.vocab, run)}
            del engine
            engine, n_eager, _, eager = serve_run(torch, params, run, trace,
                                                  prompt_lens, eager=True)
            prof["eager"] = profile_steps(torch, engine, cfg.vocab, run,
                                          mode="eager")
            del engine
            diff = [rid for rid in eager if tokens[run].get(rid) != eager[rid]]
            if diff or len(eager) != len(tokens[run]):
                fail(f"serve ({run}): requests {diff} emitted other tokens "
                     "with captured steps than with eager steps")
            if n_eager != n:
                fail(f"serve ({run}): kernel launches with captured steps "
                     f"{json.dumps(n)}, eager {json.dumps(n_eager)}")
            say(f"serve ({run}): every request's tokens and the kernel "
                "launches equal the eager run's")
            g, e = prof["graphs"], prof["eager"]
            say(f"profile ({run}): graphs vs eager: "
                f"{g['ms']:.3f} vs {e['ms']:.3f} ms per step ("
                f"{g['profiled_ms']:.3f} vs {e['profiled_ms']:.3f} profiled), "
                f"{g['host_launches']:.0f} vs {e['host_launches']:.0f} host "
                f"launches and {g['kernels']:.0f} vs {e['kernels']:.0f} "
                f"device kernels per step, device busy {g['busy']} vs "
                f"{e['busy']}")
        del params
    if tokens["lut4"] != tokens["bucketed"]:
        diff = [rid for rid in tokens["bucketed"]
                if tokens["lut4"].get(rid) != tokens["bucketed"][rid]]
        fail(f"serve (lut4): requests {diff} emitted other tokens than the "
             "w4a4_packed bucketed run (the integer math is the same)")
    say("serve (lut4): every request's tokens equal the w4a4_packed "
        "bucketed run's, token for token")
    return {k: sum(n[k] for n in launches) for k in launches[0]}


def entry_points_run(torch):
    """The port's public kernel entry points that no serving path reaches,
    called as examples/quickstart.py and benchmarks/run.py call the JAX
    package's: ops.mul4 on int4 tensors (a quickstart-sized pair and 1M
    elements, both strategies) and ops.int4_matmul on pre-quantized
    activations with a serialized N-packed weight at qwen2-0.5b's
    projection shapes.  Checks the results and returns the launches
    (counted from 0 just before)."""
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = [tuple(torch.randint(-8, 8, shape, generator=gen, device="cuda",
                                 dtype=torch.int8) for _ in range(2))
             for shape in ((4, 64), (1 << 20,))]
    gemms = []
    for (K, N), _ in GEMM_SHAPES:
        a_q = torch.randint(-8, 8, (MAX_BATCH, K), generator=gen,
                            device="cuda", dtype=torch.int8)
        w_q = torch.randint(-8, 8, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8)
        a_s = torch.rand((MAX_BATCH, 1), generator=gen, device="cuda") + 0.05
        w_s = torch.rand((1, N), generator=gen, device="cuda") + 0.05
        gemms.append((a_q, a_s, w_q, pack_int4(w_q), w_s))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    prods = [ops.mul4(a, b, strategy=s) for a, b in cases
             for s in ("onehot", "take")]
    outs = [ops.int4_matmul(a_q, a_s, w_p, w_s)
            for a_q, a_s, _, w_p, w_s in gemms]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for i, (a, b) in enumerate(cases):
        exact = (a.int() * b.int()).to(torch.int8)
        for got in prods[2 * i:2 * i + 2]:
            if got.shape != a.shape or not torch.equal(got, exact):
                fail(f"entry points: ops.mul4 on {tuple(a.shape)} is not the "
                     "exact product")
    for (a_q, a_s, w_q, _, w_s), got in zip(gemms, outs):
        acc = torch.matmul(a_q.double(), w_q.double())      # exact integers
        if not torch.equal(got, (acc.float() * a_s) * w_s):
            fail(f"entry points: ops.int4_matmul at K={a_q.shape[1]} "
                 f"N={w_q.shape[1]} is not the exact integer GEMM")
    for name in ("lut_mul4", "int4_matmul"):
        if launches[name] <= 0:
            fail(f"entry points: kernel {name} was never launched")
    say(f"entry points: ops.mul4 exact on {len(prods)} calls, "
        f"ops.int4_matmul exact at {len(outs)} shapes; kernel launches "
        f"{json.dumps(launches)}")
    return launches


def profile_steps(torch, engine, vocab: int, run: str, steps: int = 4,
                  mode: str = "graphs"):
    """Where a decode step's time goes: a full decode batch (MAX_BATCH
    requests of 200-token prompts) runs `steps` pure decode steps under
    torch.profiler, once every request decodes (ragged: 8 decode rows and
    BUDGET - 8 padding rows a step).  Prints the step wall time, the
    device's busy share (kernel time over wall time), the host's launches
    per step (a replayed step launches its graph) and the kernels the
    device ran per step, the run's GEMM and decode attention kernels'
    device time and the kernels that take the most, and checks that the
    run's GEMM launched 7 times per layer per step and its decode
    attention kernel once (a replay counts its graph's launches).  Runs
    after the serve run has read its launch counts.  `mode` ("graphs" or
    "eager") names the engine's steps in the output.  Returns the step's
    ms, host launches, device kernels and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    step = SERVE_RUNS[run][0]
    label = f"{run}, {mode}"

    gen = torch.Generator().manual_seed(SEED + 3)
    L = 200
    # bucketed: one step admits and prefills all, then decodes; ragged: the
    # prompts drain through the token budget first while the early ones
    # decode, so those need enough tokens to still run when the last starts
    new = 2 * steps + 4 + (0 if step == "bucketed"
                           else -(-MAX_BATCH * L // (BUDGET - MAX_BATCH)))
    for _ in range(MAX_BATCH):
        engine.submit(torch.randint(0, vocab, (L,), generator=gen).numpy(),
                      new)
    running = engine.scheduler.running
    while len(running) < MAX_BATCH or not all(
            r.tokens for r in running.values()):
        if engine.step() == 0:
            fail(f"profile ({label}): the engine went idle before the batch "
                 "was full")
    torch.cuda.synchronize()
    # the same steps without the profiler
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = ops.launch_counts()
    per_step = {k: (after[k] - before[k]) / steps for k in after
                if after[k] != before[k]}
    gemm = RUN_GEMM[run]
    if per_step.get(gemm) != 7 * LAYERS or any(
            per_step.get(k) for k in ("int4_matmul_fused", "w4a16_matmul",
                                      "lut4_matmul") if k != gemm):
        fail(f"profile ({label}): kernel launches per decode step {per_step}; "
             f"want {7 * LAYERS} of {gemm} and no other GEMM")
    attn = ("paged_decode_attention" if step == "bucketed"
            else "ragged_decode_attention")
    if per_step.get(attn) != LAYERS:
        fail(f"profile ({label}): kernel launches per decode step {per_step}; "
             f"want {LAYERS} of {attn}, one a layer")
    # while the batch still runs: the last step's inputs are live requests'
    replay = (_replay_ms(torch, engine._decode if step == "bucketed"
                         else engine._ragged) if mode == "graphs" else {})
    engine.run_until_idle()
    engine.collect()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel records only: a CPU op's record can carry the
    # device time of the kernels it launched as well
    kernels = sorted((e for e in events if dev_us(e) > 0
                      and str(e.device_type).endswith("CUDA")), key=dev_us,
                     reverse=True)
    busy = sum(dev_us(e) for e in kernels)
    n_launch = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx",
                                "cudaGraphLaunch"))
    n_graph = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    n_kernels = sum(e.count for e in kernels)
    busy_share = round(busy / wall_us, 3) if busy else None
    say(f"profile ({label}): {steps} decode steps at batch {MAX_BATCH}: "
        f"{plain_ms:.3f} ms per step without the profiler, "
        f"{wall_us / steps / 1e3:.3f} ms with it, "
        f"{n_launch / steps:.0f} host launches per step ({n_graph / steps:.0f}"
        f" of a graph), {n_kernels / steps:.0f} device kernels per step, "
        "device busy "
        + (f"{busy_share} of wall time" if busy else "not measured "
           "(the profiler saw no device time)")
        + f"; kernel launches per step {json.dumps(per_step)}")
    mine = [e for e in kernels if GEMM_KERNELS[gemm] in e.key]
    say(f"profile ({label}): the {gemm} kernels: "
        f"{sum(dev_us(e) for e in mine) / steps / 1e3:.3f} ms/step of device "
        f"time, {sum(e.count for e in mine) / steps:.0f} launches/step")
    mine = [e for e in kernels
            if attn.replace("_attention", "_kernel") in e.key]
    say(f"profile ({label}): the {attn} kernels: "
        f"{sum(dev_us(e) for e in mine) / steps / 1e3:.3f} ms/step of device "
        f"time, {sum(e.count for e in mine) / steps:.0f} launches/step")
    for e in kernels[:8]:
        say(f"profile ({label}):   {dev_us(e) / steps / 1e3:8.3f} ms/step "
            f"{e.count // steps:5d}x/step  {e.key[:90]}")
    # the host's side: PyTorch ops by their own CPU time (the kernel
    # wrappers' Python and ctypes calls are in no op: the rest of the wall)
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    in_ops = sum(e.self_cpu_time_total for e in host)
    say(f"profile ({label}): host time in PyTorch ops {in_ops / wall_us:.3f} "
        "of wall time; the largest:")
    for e in host[:6]:
        say(f"profile ({label}):   {e.self_cpu_time_total / steps / 1e3:8.3f} "
            f"ms/step {e.count // steps:5d}x/step  {e.key[:90]}")
    if replay:
        say(f"profile ({label}): the full-batch step's graph replayed "
            f"{REPLAYS} times back to back: {replay['replay_ms']:.3f} ms of "
            f"device time a replay, {replay['launch_ms']:.3f} ms of host "
            "time to launch one")
    return {"ms": plain_ms, "profiled_ms": wall_us / steps / 1e3,
            "host_launches": n_launch / steps, "kernels": n_kernels / steps,
            "busy": busy_share, **replay}


#: back-to-back replays of a step's graph timed by `_replay_ms`
REPLAYS = 20


def _replay_ms(torch, captured):
    """The device time of one replay of `captured`'s widest graph (the
    full decode batch, or the token budget), replayed REPLAYS times back to
    back on its static inputs (the last step's: each replay rewrites the
    same K/V), and the host's time to launch one."""
    g = max(captured._graphs.values(), key=lambda g: g.static[0].numel())
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    for _ in range(REPLAYS):
        g.graph.replay()
    e.record()
    host = (time.perf_counter() - t0) / REPLAYS * 1e3
    torch.cuda.synchronize()
    return {"replay_ms": s.elapsed_time(e) / REPLAYS, "launch_ms": host}


# ------------------------------------------------------------ phase 5 ----
def _two_devices(torch, rt):
    """Full width cut to 2 layers, the same weights on both devices: one
    prefill of a left-padded prompt and three decode steps fed fixed tokens
    (so a flipped argmax cannot send the two runs down different paths).
    Returns {device: logits [4, vocab] f32 on the CPU} and the launch
    counts of the card's run."""
    from repro_torch.configs import ServingConfig, get_config
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving.engine import build_params
    from repro_torch.serving.kv_pages import (init_paged_caches,
                                              with_block_tables)

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    sv = ServingConfig(layout="paged", max_batch=1, page_size=PAGE_SIZE,
                       num_pages=8, max_ctx=128)
    params_gpu = build_params(cfg, rt, seed=SEED + 5, device="cuda")
    params_cpu = tree_to(params_gpu, "cpu")
    gen = torch.Generator().manual_seed(SEED + 6)
    L, Lb = 40, 64
    prompt = torch.randint(0, cfg.vocab, (L,), generator=gen)
    feed = torch.randint(0, cfg.vocab, (3,), generator=gen)
    tokens = torch.zeros((1, Lb), dtype=torch.int32)
    tokens[0, Lb - L:] = prompt
    base = torch.arange(Lb, dtype=torch.int32) - (Lb - L)
    positions = torch.where(base >= 0, base, -1)[None]
    tbl = torch.arange(sv.pages_per_seq, dtype=torch.int32)[None]
    logits = {}
    with torch.inference_mode():
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if dev == "cuda":
                ops.reset_launch_counts()
            caches = with_block_tables(
                init_paged_caches(cfg, rt, sv, device=dev), tbl.to(dev))
            lg, caches = prefill(params, tokens.to(dev), cfg, rt, caches,
                                 positions.to(dev))
            out = [lg.float().cpu()]
            for i in range(len(feed)):
                lg, caches = decode_step(
                    params, feed[i].reshape(1, 1).to(torch.int32).to(dev),
                    cfg, rt, caches,
                    torch.tensor([[L + i]], dtype=torch.int32, device=dev))
                out.append(lg.float().cpu())
            logits[dev] = torch.cat(out)[:, :cfg.vocab]
            if dev == "cuda":
                launches = ops.launch_counts()
    return logits, launches


def _two_devices_ragged(torch, rt):
    """Full width cut to 2 layers, the same weights on both devices, the
    ragged step's forward at the budget's width: one pack of two prefill
    chunks (slot 0: a 40-token prompt, slot 1: a 20-token prompt) and
    padding, then three packs of the two decode rows fed fixed tokens.
    Returns {device: logits of the emitted rows [8, vocab] f32 on the
    CPU} and the launch counts of the card's run."""
    from repro_torch.configs import ServingConfig, get_config
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import _logits, forward
    from repro_torch.serving.engine import build_params
    from repro_torch.serving.kv_pages import (init_paged_caches,
                                              with_token_slots)

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    sv = ServingConfig(layout="paged", max_batch=2, page_size=PAGE_SIZE,
                       num_pages=16, max_ctx=128, step="ragged")
    params_gpu = build_params(cfg, rt, seed=SEED + 5, device="cuda")
    params_cpu = tree_to(params_gpu, "cpu")
    gen = torch.Generator().manual_seed(SEED + 7)
    lens = (40, 20)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in lens]
    feed = torch.randint(0, cfg.vocab, (3, 2), generator=gen)
    packs = []                                # (tokens, pos, slots, emit)
    tok = torch.zeros((1, BUDGET), dtype=torch.int32)
    pos = torch.full((1, BUDGET), -1, dtype=torch.int32)
    slots = torch.full((BUDGET,), -1, dtype=torch.int32)
    used = 0
    for s, p in enumerate(prompts):
        tok[0, used:used + len(p)] = p
        pos[0, used:used + len(p)] = torch.arange(len(p))
        slots[used:used + len(p)] = s
        used += len(p)
    packs.append((tok, pos, slots, torch.tensor([lens[0] - 1, used - 1])))
    for i in range(len(feed)):
        tok = torch.zeros((1, BUDGET), dtype=torch.int32)
        pos = torch.full((1, BUDGET), -1, dtype=torch.int32)
        slots = torch.full((BUDGET,), -1, dtype=torch.int32)
        tok[0, :2] = feed[i]
        pos[0, :2] = torch.tensor([lens[0] + i, lens[1] + i])
        slots[:2] = torch.tensor([0, 1])
        packs.append((tok, pos, slots, torch.tensor([0, 1])))
    tbl = torch.arange(16, dtype=torch.int32).reshape(2, sv.pages_per_seq)
    logits = {}
    with torch.inference_mode():
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if dev == "cuda":
                ops.reset_launch_counts()
            caches = init_paged_caches(cfg, rt, sv, device=dev)
            out = []
            for tok, pos, slots, emit in packs:
                caches = with_token_slots(caches, tbl.to(dev), slots.to(dev))
                hidden, caches = forward(params, tok.to(dev), cfg, rt,
                                         pos.to(dev), caches,
                                         update_cache=True,
                                         return_hidden=True)
                h = hidden.index_select(1, emit.to(dev))
                out.append(_logits(params, h, cfg, rt)[0].float().cpu())
            logits[dev] = torch.cat(out)[:, :cfg.vocab]
            if dev == "cuda":
                launches = ops.launch_counts()
    return logits, launches


def _compare(torch, what, logits, launches):
    """Print the card-vs-CPU reading of one run; returns (max |diff|,
    correlation)."""
    a, b = logits["cuda"], logits["cpu"]
    diff = (a - b).abs()
    corr = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]
    relrms = (diff.square().mean() / b.square().mean()).sqrt().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    say(f"cpu: {what}: max |logit diff| {diff.max().item():.6g}, mean "
        f"{diff.mean().item():.6g}, rel rms {relrms:.6g}, corr "
        f"{corr.item():.6f} (|logit| <= {b.abs().max().item():.3f}), "
        f"argmax agreement {agree:.2f}, card launches "
        f"{json.dumps(launches)}")
    if not torch.isfinite(a).all():
        fail(f"cpu: {what}: non-finite logits on the card")
    return diff.max().item(), corr.item()


def _w4a16_cpu_runs():
    """Phase 5's runs of the third slice: W4A16 in bf16, per channel and
    grouped (no activation quantize, so no int4 rounding boundary amplifies
    a one-step bf16 difference: held to CPU_ATOL like float weights), and
    the mixed plan in float32 (on-the-fly w4a16 FFNs, int_sim W4A4 and a
    float block-0 attention: held to CPU_W4A4_F32_ATOL)."""
    from repro_torch.configs import Runtime

    return (
        ("W4A16 weights per channel (w4a16_packed), bf16",
         Runtime(attn_impl="flash", quant_backend="w4a16_packed"), CPU_ATOL),
        (f"W4A16 weights grouped ({W4A16_PLAN}), bf16",
         Runtime(attn_impl="flash", quant_plan=W4A16_PLAN), CPU_ATOL),
        ("mixed_sensitive plan, float32",
         Runtime(attn_impl="chunked", paged_attn="gather",
                 quant_plan="mixed_sensitive", compute_dtype="float32",
                 cache_dtype="float32"), CPU_W4A4_F32_ATOL),
    )


def phase_cpu(torch):
    """The card against the CPU path that the tests hold to the JAX
    package.  Eight runs, each on both devices; the bucketed step's six
    (the last three in `_w4a16_cpu_runs`):

      * float weights, bf16 activations, flash prefill and fused paged
        decode: every op rounds to bf16 on both devices, sums run in other
        orders, the attention kernels differ from their plain versions by
        up to 2e-2; the logits must agree within CPU_ATOL.
      * the serving path's W4A4-packed weights in float32 (chunked prefill
        and gather decode, the attention kernels being bf16-only): every
        projection goes through the CUDA GEMM on the card and its plain
        version on the CPU, whose integer math is exact; the logits must
        agree within CPU_W4A4_F32_ATOL.  This holds the card's W4A4 path
        elementwise, as tests/test_torch_model.py holds the CPU path to
        the JAX package.
      * the serving path itself (W4A4 in bf16): a one-step bf16 difference
        that lands an activation on the other side of an int4 rounding
        boundary, or moves a row's amax, moves that row's projection by a
        whole quantization step, and the next layer amplifies it, so no
        elementwise bound holds (tests/test_torch_model.py shows the same
        spread between the JAX package and the port on one CPU).  Its
        logits must stay finite; their correlation is reported and must
        stay >= CPU_W4A4_CORR.
      * W4A16 weights in bf16, per channel and grouped: the W4A16 kernel on
        the card, its plain version on the CPU; within CPU_ATOL.
      * the mixed_sensitive plan in float32; within CPU_W4A4_F32_ATOL.

    and the ragged step's two, float weights in bf16 (the ragged kernel on
    the card, its plain version on the CPU): on a bf16 pool and on an int8
    pool, the logits of the emitted rows must agree within CPU_ATOL.  The
    int8 run holds the card's quantizing writes (scales and bytes) and the
    dequantizing kernel against the CPU path that the tests hold to the
    JAX package.
    """
    from repro_torch.configs import Runtime

    runs = (
        ("float weights, bf16",
         Runtime(attn_impl="flash", quant_backend="float"), CPU_ATOL),
        ("W4A4 weights, float32",
         Runtime(attn_impl="chunked", paged_attn="gather",
                 quant_backend="w4a4_packed", compute_dtype="float32",
                 cache_dtype="float32"), CPU_W4A4_F32_ATOL),
        ("W4A4 weights, bf16 (serving path)",
         Runtime(attn_impl="flash", quant_backend="w4a4_packed"), None),
    ) + _w4a16_cpu_runs()
    readings = {}
    for what, rt, atol in runs:
        logits, launches = _two_devices(torch, rt)
        what = (f"{what}, 2 layers at full width, prefill + 3 decode "
                "steps")
        err, corr = _compare(torch, what, logits, launches)
        readings[what] = err
        if rt.quant_backend == "w4a4_packed" \
                and launches["int4_matmul_fused"] <= 0:
            fail(f"cpu: {what}: the card's run never launched the W4A4 GEMM")
        if (rt.quant_plan or rt.quant_backend).startswith(("w4a16", "mixed")) \
                and launches["w4a16_matmul"] <= 0:
            fail(f"cpu: {what}: the card's run never launched the W4A16 GEMM")
        if atol is not None and err > atol:
            fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} > "
                 f"{atol}")
        if atol is None and corr < CPU_W4A4_CORR:
            fail(f"cpu: {what}: card and CPU logits correlate {corr:.4f} < "
                 f"{CPU_W4A4_CORR}")
    for pool in ("bfloat16", "int8"):
        rt = Runtime(quant_backend="float", cache_dtype=pool)
        logits, launches = _two_devices_ragged(torch, rt)
        what = (f"ragged step, float weights, bf16, {pool} pool, 2 layers at "
                "full width, two prefill chunks + 3 decode packs")
        err, _ = _compare(torch, what, logits, launches)
        readings[what] = err
        if launches["ragged_decode_attention"] <= 0:
            fail(f"cpu: {what}: the card's run never launched the ragged "
                 "kernel")
        if err > CPU_ATOL:
            fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} > "
                 f"{CPU_ATOL}")
    return readings


# --------------------------------------------------------------- main ----
SOURCES = {
    "int4_matmul_fused": ("src/repro_torch/csrc/int4_matmul.cu",
                          "src/repro/kernels/int4_matmul.py:138"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/paged_attention.py:384"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:157"),
    "ragged_decode_attention": ("src/repro_torch/csrc/ragged_decode.cu",
                                "src/repro/kernels/ragged_attention.py:133"),
    "w4a16_matmul": ("src/repro_torch/csrc/w4a16_matmul.cu",
                     "src/repro/kernels/w4a16_matmul.py:89"),
    "lut4_matmul": ("src/repro_torch/csrc/lut4_matmul.cu",
                    "src/repro/kernels/lut4_matmul.py:83"),
    "int4_matmul": ("src/repro_torch/csrc/int4_matmul.cu",
                    "src/repro/kernels/int4_matmul.py:123"),
    "lut_mul4": ("src/repro_torch/csrc/lut_mul4.cu",
                 "src/repro/kernels/lut_mul4.py:66"),
}


def main() -> None:
    import torch

    kind, smi = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    timer = Timer(torch)
    results = {"int4_matmul_fused": check_gemm(torch, timer),
               "flash_prefill": check_flash(torch, timer),
               "paged_decode_attention": check_decode(torch, timer),
               "ragged_decode_attention": check_ragged(torch, timer)}
    results["w4a16_matmul"] = check_w4a16(torch, timer)
    results["lut4_matmul"], results["int4_matmul"] = check_lut4_int4(torch,
                                                                     timer)
    results["lut_mul4"] = check_mul4(torch, timer)
    del timer
    launches = phase_serve(torch)
    entry = entry_points_run(torch)
    launches = {k: launches[k] + entry[k] for k in launches}
    phase_cpu(torch)
    kernels = []
    for name, res in results.items():
        source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **res})
    say(f"total: {time.perf_counter() - t_start:.1f} s after device checks")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
