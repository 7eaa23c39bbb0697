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
                 w4a4_ kernel; then at mamba2-130m's in_proj (768, 3352:
                 1-byte weight loads) and out_proj (1536, 768) at M = 1, 8,
                 32, 96, 160 and 256, timed at 8 and 256; then at
                 recurrentgemma-9b's (4096, 4096), (4096, 256), (4096,
                 12288) and (12288, 4096) at M = 8 and 256, timed, two
                 calls bit-equal, and so at qwen3-4b's, qwen2-vl-2b's and
                 internlm2-20b's, starcoder2-7b's, musicgen-large's,
                 arctic-480b's (attention and dense FFN) and
                 llama4-maverick's (attention and shared expert)
                 projections, DENSE_GEMM_SHAPES), the
                 attention kernels
                 within atol 2e-2 (bf16) on bf16, int8 and int4 pools with
                 padding rows exactly 0 (flash prefill at the prompt
                 buckets 32, 128 and 256, a prefix-hit tail, hd 128 at
                 qwen3-4b's 32 heads over 8, qwen2-vl-2b's 12 over 2 and
                 internlm2-20b's 48 over 8, and recurrentgemma-9b's hd 256
                 (16 heads over 1)
                 fresh and on the tail, each with and without a window,
                 two calls bit-equal, each shape's plan printed, its ptxas
                 report (any spill fails), and a method gate: `cuobjdump
                 -sass` shows HMMA in every
                 flash kernel), paged decode and the ragged kernel at
                 every DECODE_SHAPES shape (hd 64 at qwen2-0.5b's 14 heads
                 over 2 and at G = 1, hd 128 at G = 4, 5, 6, 7 and 9) with
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
                 token budget 64, ragged decode) on the first 8 of those
                 24 layers (RUN_LAYERS); then the Poisson trace on
                 the bucketed step under the pre-packed grouped W4A16 plan
                 (W4A16_PLAN) and under lut4 (on-the-fly weights from the
                 same masters), both at 8 of the 24 layers (RUN_LAYERS),
                 the lut4 run's tokens equal to a W4A4 run's at that
                 depth.
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
                 captured step beside the eager one, and
                 engine.profile()'s attribution (one decode step against
                 its decode attention alone) beside the graph's replay.
                 Then, on W4A4 weights at 8 of the 24 layers (RUN_LAYERS):
                 shared-prefix traffic (PREFIX_TRACE: a 128-token system
                 prompt for all 8 requests) on the bucketed and the ragged
                 step, bf16 pool,
                 each served captured, eager and captured with the prefix
                 cache off: every request ok, prefix-hit tokens > 0, a
                 prefill_tail shape captured and flash prefill launched
                 (bucketed), captured tokens and launches equal to eager,
                 tokens/s, TTFT p50 and hit rate beside the cold run's and
                 token agreement with it reported; the bucketed captured
                 run records the trace recorder's timeline, saved and
                 checked as Chrome trace JSON with one lane per slot.  Then
                 the chaos harness (serving.chaos.run_chaos, exact-softmax
                 prefill as the CLI runs it): seed 0 with restores at
                 steps 6 and 14 in both step modes and the cancel storm on
                 the bucketed step, each held to a fault-free run of its
                 own mode (survivors' tokens equal, no leaked pages, every
                 request retired with an outcome, invariants after every
                 event), with the memory allocated on the card read at
                 each snapshot and after the run (flat within
                 RESTORE_SLACK_BYTES) and each engine's captures printed.
                 Then the
                 public entry points no serving path reaches (ops.mul4,
                 ops.int4_matmul), called as the JAX package's quickstart
                 and benchmarks call theirs.  Then the paper's circuit
                 (circuit_runs), each step failing the run on a mismatch:
                 (a) the proposed multiplier, lm and acc_ullah exact on all
                 256 pairs on the card in both evaluation modes, their INIT
                 tables, area, timing and the pipelined report printed (the
                 FPGA model's numbers; proposed must read 11 LUTs, 2 CARRY4,
                 CPD 2.750 ns = 1.302 logic + 1.448 net); (b) 2^24 seeded
                 signed int4 pairs through the netlist in both modes equal
                 to the lut_mul4 kernel and a * b, timed beside it; (c)
                 full-width qwen2-0.5b, one 16-token prompt: `forward` under
                 *=netlist gives logits bit-equal to *=int_sim (the fused
                 W4A4 kernel) and *=lut4; (d) the widths no kernel serves
                 (int_sim/a8, int_sim/w8/a8, lut4/a8, pallas_int4/w8/a8,
                 pre-packed w4a4_packed/a8, w4a16/w8) at M = 1, 8, 16, 17,
                 64 on the projection shapes, the integer ones bit-equal to
                 a float64 integer GEMM, w4a16/w8 within 1e-5 relative; (e)
                 the sensitivity sweep at full width (batch 2, seq 16): the
                 int_sim and lut4 rows equal, every MSE finite and above 0.
                 Also on W4A4 weights at 8 of the 24 layers (RUN_LAYERS),
                 after the chaos runs: the contiguous KV layout
                 (`contiguous_runs`: the Poisson trace, flash prefill,
                 captured and eager, tokens equal to a paged_gather run,
                 no decode attention kernel) and the compare harness
                 (`compare_runs`: the five attention paths of `serve
                 --layout compare`, exact-softmax prefill,
                 under W4A4 and under float weights in bf16; contiguous =
                 paged_gather and paged = paged_nocache gated, the other
                 agreements printed).  Last, full-width mamba2-130m
                 (`mamba_runs`: the contiguous layout with exact-length
                 prefill, W4A4 in_proj/out_proj, the Poisson trace,
                 captured and eager, one graph per prompt length and
                 decode bucket, no attention kernel, the GEMM 2 times a
                 layer a forward).  Then full-width recurrentgemma-9b
                 (`hybrid_runs`: 38 layers, (R, R, A) x 12 + (R, R),
                 W4A4-packed projections, float lm_head, the contiguous
                 layout with exact-length prefill and flash prefill at hd
                 256, the Poisson trace, captured and eager, the build's
                 time and peak memory printed; the GEMM 8 times an R layer
                 and 7 an A layer a forward, flash once an attention layer
                 a prefill, no decode attention kernel).  Then the paged
                 configs (`dense_runs`) on the paged layout
                 and the Poisson trace, W4A4-packed projections, flash
                 prefill, bf16 pool, bucketed, captured and eager:
                 qwen3-4b (36 layers, qk_norm; also the mixed trace on the
                 ragged step with an int8 pool at 8 of its layers, and its
                 captured decode step profiled), qwen2-vl-2b (8 of its 28
                 layers, M-RoPE),
                 internlm2-20b (24 of its 48 layers, built a layer at a
                 time),
                 starcoder2-7b (32 layers, GELU FFN with biases),
                 musicgen-large (48 layers, sinusoidal positions, MHA at
                 hd 64), arctic-480b and llama4-maverick at MOE_LAYERS
                 layers (RUN_LAYERS; every expert of a layer on the card,
                 layer 0's MoE block first held two calls bit-equal at a
                 decode batch and a prefill); the GEMM 7 times a layer a
                 forward (6 for the GELU configs), flash once a layer a
                 prefill, paged decode (or the ragged kernel) once a layer
                 a step.  Last, training (`train_runs`): full-width
                 qwen2-0.5b's train step at 2 layers in float32 on the card
                 against the CPU (loss within TRAIN_CPU_LOSS_RTOL, grad
                 norm within TRAIN_CPU_GNORM_RTOL); then all 24 layers
                 QAT-trained (fake_quant W4A4) by `launch.train.train`
                 under deterministic algorithms, 6 steps of 8 x 128
                 tokens (every loss and grad norm finite; step ms, tokens/s
                 trained and peak memory printed), the same run preempted
                 at step 3 and resumed from its checkpoint by a new
                 `train()` (final state bit-equal to the straight run's),
                 the trained masters saved as a serve_w4a4 quantized
                 checkpoint and restored (logits bit-equal to the
                 in-memory pack; sizes and times printed), and the Poisson
                 trace served from the restored tree, captured (8 of 8 ok,
                 the GEMM 7 times a layer a forward, flash prefill and
                 paged decode once a layer a prefill or step).  Then the
                 distribution layer (`dist_runs`): NCCL initialised at
                 world 1 on a file:// store (its version printed, an
                 all-reduce run); 2 QAT steps of full-width qwen2-0.5b by
                 `train(mesh_spec="1,1")` against `train()` (remat none,
                 deterministic algorithms): losses and final state
                 bit-equal; a W4A4-packed prefill and 3 decode steps
                 (contiguous cache, flash prefill) under a (1, 1) mesh
                 against the unsharded steps: logits bit-equal, the
                 fused GEMM and flash launched; and qwen2-0.5b's and
                 qwen3-4b's projections cut for tp 2 and 4, each rank's
                 local W4A4 GEMM run in turn (column shards: the fused
                 kernel; row shards: the global amax, the unfused kernel's
                 integer partials summed, then the scales), bit-equal to
                 the whole projection's kernel call at M = 8 and 256, each
                 shard shape's plan and its time beside the whole's; and
                 their row-parallel projections under int_sim, lut4 and
                 w4a16 from float masters and packed w4a16 (ROW_BACKENDS),
                 every rank's shipped body in a thread of its own, the sum
                 bit-equal to the whole call for the integer GEMMs and
                 within W4A16_RTOL for W4A16.  Last, the dry-run
                 (`dryrun_runs`): DRYRUN_CELLS on the production meshes,
                 each in a subprocess on a fake process group of 256 or
                 512 ranks (status lines printed, every one ok); four
                 steps of full-width qwen2-0.5b at a (1, 1) mesh (the
                 W4A4-packed eager decode over an int4 cache of 512, its
                 prefill, a float prefill of 8 x 1024, a QAT train step)
                 run on the card and dry-run:
                 argument bytes equal, the dry-run's lower bound at most
                 the measured time; and the pipeline's backward at one
                 NCCL stage with a full-width block, bit-equal to the
                 unpipelined block's.
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
                 Mamba: full-width mamba2-130m (24 layers), W4A4 weights in
                 float32, a prefill and three decode steps on contiguous
                 caches, logits within CPU_W4A4_F32_ATOL.  Hybrid:
                 full-width recurrentgemma-9b at one (R, R, A) unit and the
                 (R, R) tail (5 layers), the same reading and bound.
                 Dense: qwen3-4b and qwen2-vl-2b at full width, 2 layers,
                 bucketed: W4A4 weights in float32 (within
                 CPU_W4A4_F32_ATOL: qk_norm and M-RoPE against the CPU
                 path) and float weights in bf16 through flash prefill and
                 paged decode at hd 128 (within CPU_ATOL); starcoder2-7b
                 and arctic-480b, W4A4 weights in float32, arctic's routed
                 expert ids equal on both devices, both within
                 CPU_W4A4_F32_ATOL.
  6. analysis -- the port's static analyzer (python -m
     and tuning  repro_torch.analysis) over the tree as shipped against
                 analysis_baseline_torch.json, exit 0 and its counts; then
                 the GEMM plans' timed search (kernels.autotune.tune) at
                 qwen2-0.5b's (896, 4864): the W4A4 GEMM at M = 8 and 256,
                 lut4 and W4A16 (G = 128) at M = 8, each candidate's us,
                 the rule's and the winner's, every timed candidate held
                 to its plain version, the cache (a file of the run's own,
                 set for the whole script) saved, dropped and read back
                 into the wrappers' plans, and the host us of a wrapper's
                 plan with the cache loaded, empty and not read.

The line before the last is a JSON object with every kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reproducible run to run (needed by the training phase's
# deterministic algorithms); must be set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
#: the serve runs cut in depth (full width), so that the script keeps its
#: time as later slices add runs: the W4A16, lut4, shared-prefix and chaos
#: runs at 8 of 24 layers (the lut4 run's tokens are held to a W4A4 run at
#: the same depth), and since the dense hd-128 runs the contiguous layout's
#: and the compare harness's; since the GELU and MoE runs, qwen2-vl-2b's
#: run and qwen3-4b's ragged run (the first 8 layers of its 36-layer
#: weights; its bucketed run and profile stay at 36).  The MoE configs at
#: MOE_LAYERS of their 35 and 48: every expert lives on the one card
#: (arctic-480b's packed layer is 6.9 GB, llama4-maverick's 8.2 GB); 4
#: layers until the training phase came, 2 since.  Since then also the
#: W4A4 ragged run, on the first 8 of the bucketed run's 24 layers.
#: internlm2-20b ran all 48 layers from the layer-at-a-time build (its f32
#: masters, ~79 GB, never exist at once) until the dry-run phase came; 24
#: since, for the time.
MOE_LAYERS = 2
RUN_LAYERS = {**dict.fromkeys(("w4a16", "lut4", "prefix_bucketed",
                               "prefix_ragged", "chaos", "contiguous",
                               "compare", "qwen2-vl-2b", "qwen3-4b ragged",
                               "ragged"),
                              8),
              "internlm2-20b": 24,
              **dict.fromkeys(("arctic-480b", "llama4-maverick-400b-a17b"),
                              MOE_LAYERS)}


def _w4a4_params(n_layers: int):
    """qwen2-0.5b's W4A4-packed weights at full width and `n_layers`
    layers, random from SEED (the first layers of the full model's)."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.serving.engine import build_params

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=n_layers)
    return build_params(cfg, Runtime(quant_backend="w4a4_packed"),
                        seed=SEED, device="cuda")

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


#: the rows the W4A4 kernel is checked at on mamba2-130m's projections:
#: decode rows and the exact prompt lengths of phase 4's trace; timed at
#: M = 8 and 256
MAMBA_GEMM_ROWS = (1, MAX_BATCH) + (32, 96, 160, 256)
MAMBA_TIMED_ROWS = (MAX_BATCH, PROMPT_BUCKET)
#: recurrentgemma-9b's projections, (K, N) and how many of each a layer
#: runs: (4096, 4096) the RG-LRU's in_x, in_g, w_a, w_x and out (5 a
#: recurrent layer) and the attention's wq and wo (2 an attention layer);
#: (4096, 256) wk and wv; (4096, 12288) w_in and w_gate; (12288, 4096)
#: w_out.  The counts are one recurrent layer's, and an attention layer's
HYBRID_GEMM_SHAPES = (((4096, 4096), (5, 2)), ((4096, 256), (0, 2)),
                      ((4096, 12288), (2, 2)), ((12288, 4096), (1, 1)))
HYBRID_GEMM_ROWS = (MAX_BATCH, PROMPT_BUCKET)
#: the paged configs' projections, (K, N) and how many of each a layer
#: runs: wq and wo; wk and wv; w_in and w_gate; w_out (qwen2-vl-2b's wq and
#: wo share a shape, as do internlm2-20b's)
DENSE_GEMM_SHAPES = {
    "qwen3-4b": (((2560, 4096), 1), ((2560, 1024), 2), ((4096, 2560), 1),
                 ((2560, 9728), 2), ((9728, 2560), 1)),
    "qwen2-vl-2b": (((1536, 1536), 2), ((1536, 256), 2), ((1536, 8960), 2),
                    ((8960, 1536), 1)),
    "internlm2-20b": (((6144, 6144), 2), ((6144, 1024), 2),
                      ((6144, 16384), 2), ((16384, 6144), 1)),
    # GELU FFNs (w_in, w_out; no w_gate): wq and wo; wk and wv (G = 9);
    # w_in; w_out.  musicgen-large's four attention projections share one
    # shape (MHA at hd 64)
    "starcoder2-7b": (((4608, 4608), 2), ((4608, 512), 2),
                      ((4608, 18432), 1), ((18432, 4608), 1)),
    "musicgen-large": (((2048, 2048), 4), ((2048, 8192), 1),
                       ((8192, 2048), 1)),
    # MoE: the attention, then arctic-480b's dense residual FFN and
    # llama4-maverick's shared expert (SwiGLU); the experts run as batched
    # GEMMs outside the kernel
    "arctic-480b": (((7168, 7168), 2), ((7168, 1024), 2),
                    ((7168, 4864), 2), ((4864, 7168), 1)),
    "llama4-maverick-400b-a17b": (((5120, 5120), 2), ((5120, 1024), 2),
                                  ((5120, 8192), 2), ((8192, 5120), 1)),
}


def check_gemm_at(torch, timer, label, shapes, rows, timed, seed):
    """The fused W4A4 kernel on one model's projections (`shapes`: ((K, N),
    count) pairs) bit for bit against its plain version at every M of
    `rows` (each shape's plan printed), and timed at the M of `timed`
    beside the bound and the yardstick (_int_mm, at M <= 16 a float32
    torch.matmul on the int values).  mamba2-130m's in_proj, N = 3352,
    takes the 1-byte weight loads (N % 16 = 8); recurrentgemma-9b's
    w_out has K = 12288, the longest K the kernel meets.  Returns
    {"M=<m> K=<k> N=<n>": {ms, plain_ms, bound_ms, bound_by, library_ms}}
    and the worst |diff| (0)."""
    from repro_torch.kernels.int4_matmul import (
        int4_matmul_fused_cuda, int4_matmul_fused_plain, w4a4_plan)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, worst = {}, 0.0
    for M in rows:
        for (K, N), _ in shapes:
            x, w_q, w_km, w_scale = _gemm_inputs(torch, gen, M, K, N)
            p = w4a4_plan(M, K, N, w_km.shape[0], w_km.data_ptr() % 16 == 0)
            got = int4_matmul_fused_cuda(x, w_km, w_scale)
            want = int4_matmul_fused_plain(x, w_km, w_scale)
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"int4_matmul_fused ({label}) M={M} K={K} N={N}: kernel "
                     f"differs from the plain version (max |diff| {err})")
            if M in timed and not torch.equal(
                    got, int4_matmul_fused_cuda(x, w_km, w_scale)):
                fail(f"int4_matmul_fused ({label}) M={M} K={K} N={N}: two "
                     "calls on the same inputs differ")
            line = (f"gemm ({label}) M={M:4d} K={K:5d} N={N:5d}: bit-exact; "
                    f"plan {p.bm} x {p.bn} tiles, {p.vec}-byte weight loads, "
                    f"{p.splits} splits of {p.rows} packed rows, {p.ctas} "
                    "CTAs")
            if M in timed:
                n_bytes = M * K * 4 + w_km.numel() + N * 4 + M * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * M * K * N,
                                      INT8_OPS_PER_S)
                t = timer.ms(lambda: int4_matmul_fused_cuda(x, w_km,
                                                            w_scale))
                tp = timer.ms(lambda: int4_matmul_fused_plain(
                    x, w_km, w_scale), reps=5)
                a8 = torch.clamp(torch.round(x * 7.0 / x.abs().amax()), -8,
                                 7).to(torch.int8)
                lib = _int_yardstick_ms(torch, timer, a8, w_q)
                out[f"M={M} K={K} N={N}"] = {
                    "ms": t, "plain_ms": tp, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib}
                line += (f"; kernel {t:.4f} ms, plain {tp:.4f} ms, bound "
                         f"{b_ms:.5f} ms ({b_by}), "
                         + ("_int_mm" if M > 16 else "f32 matmul")
                         + f" {lib:.4f} ms")
            say(line)
    return out, worst


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


def _pools(torch, gen, P, ps, kv=KV, hd=HD):
    """{pool dtype: (k, v, k_scale, v_scale)}: one set of seeded normal K/V
    values [P, ps, kv, hd] as a bf16 pool and quantized per (token, head)
    into int8 and int4 pools, as the serving writes store them."""
    from repro_torch.models.attention import quantize_kv

    vals = [torch.randn((P, ps, kv, hd), generator=gen, device="cuda")
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
    [rows, pps * ps, KV, hd], dequantized like the reference's gather."""
    from repro_torch.models.attention import dequantize_kv

    idx = tbl.clamp(max=P - 1).long()
    g = pool[idx]                                   # [rows, pps, ps, KV, w]
    if scale is not None:
        g = dequantize_kv(g, scale[idx])
    return g.reshape(tbl.shape[0], -1, *g.shape[-2:])


def _sdpa(torch, q, kf, vf, mask):
    """q [rows, H, hd] against dense kf/vf [rows, S, KV, hd] with a
    [rows, S] mask, GQA expanded: the yardstick's one library call."""
    G = q.shape[1] // kf.shape[2]
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


def decode_inputs(torch, gen, shape=(H, KV, HD)):
    """The paged decode check's operands at the serving shape: q [8, H, hd]
    bf16 (`shape` = (H, KV, hd)), a table of DECODE_PPS pages a row over
    DECODE_PAGES pages, the rows' last positions, and the pools of
    `_pools`."""
    nh, nkv, hd = shape
    B = len(DECODE_LAST)
    q = torch.randn((B, nh, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    tbl = _table(torch, gen, B, DECODE_PAGES, DECODE_PPS, DECODE_LAST)
    lp = torch.tensor(DECODE_LAST, dtype=torch.int32, device="cuda")
    return q, tbl, lp, _pools(torch, gen, DECODE_PAGES, PAGE_SIZE, nkv, hd)


#: the decode kernels' shapes (H, KV, hd) at the serving table: qwen2-0.5b's
#: (the top level of the kernels line) and every paged config's served in
#: phase 4: hd 128 at G = 4 (qwen3-4b), 6 (qwen2-vl-2b, internlm2-20b),
#: 9 (starcoder2-7b), 7 (arctic-480b), 5 (llama4-maverick), hd 64 at G = 1
#: (musicgen-large)
DECODE_SHAPES = {"qwen2-0.5b": (H, KV, HD), "qwen3-4b": (32, 8, 128),
                 "qwen2-vl-2b": (12, 2, 128), "internlm2-20b": (48, 8, 128),
                 "starcoder2-7b": (36, 4, 128),
                 "musicgen-large": (32, 32, 64),
                 "arctic-480b": (56, 8, 128),
                 "llama4-maverick": (40, 8, 128)}


def check_decode(torch, timer):
    """The paged decode kernel against its plain version at every
    DECODE_SHAPES shape on bf16, int8 and int4 pools at the serving
    table, with and without a window: within ATTN_ATOL, idle rows exactly
    zero, two calls bit-equal.  Prints the split plan, the ptxas report of
    both decode kernels (fails on spill), and times the kernel, the plain
    version, gather + SDPA and the floor (an empty launch of the same grid
    and cluster) at every shape.  The result's top level is qwen2-0.5b's
    shape; `shapes` holds every shape's row."""
    from repro_torch.kernels.paged_attention import decode_plan

    ptxas = decode_ptxas("paged_decode", "paged_decode_kernel")
    ps, pps = PAGE_SIZE, DECODE_PPS
    B = len(DECODE_LAST)
    plan = decode_plan(pps * ps, ps)
    say(f"paged decode plan (table {pps * ps} tokens, ps {ps}): {plan}, grid "
        f"({B}, KV, {plan.nsplit})")
    shapes = {label: _decode_at(torch, timer, label, shape)
              for label, shape in DECODE_SHAPES.items()}
    top = shapes["qwen2-0.5b"]
    return {**top,
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "ptxas": ptxas, "shapes": shapes}


def _decode_at(torch, timer, label, shape):
    """`check_decode` at one (H, KV, hd) shape."""
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        decode_floor_cuda, paged_decode_attention_cuda,
        paged_decode_attention_plain)

    nh, nkv, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ps, P, pps = PAGE_SIZE, DECODE_PAGES, DECODE_PPS
    last_pos = DECODE_LAST
    B = len(last_pos)
    q, tbl, lp, pools = decode_inputs(torch, gen, shape)
    pp = max(1, attn_default_blocks("attn.paged_decode", B, pps * ps,
                                    nh * hd, group_size=ps)["bk"] // ps)
    idle = [b for b, x in enumerate(last_pos) if x < 0]
    n_tok = sum(x + 1 for x in last_pos if x >= 0)
    n_pages = sum(-(-(x + 1) // ps) for x in last_pos if x >= 0)
    S = pps * ps
    mask = torch.arange(S, device="cuda")[None, :] <= lp[:, None]
    dev = torch.device("cuda")
    floor = timer.ms(lambda: decode_floor_cuda(B, nkv, ps, pps, dev))
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
                fail(f"paged_decode_attention ({label}, {dt} pool, window "
                     f"{window}): max |diff| {err} > {ATTN_ATOL} or an idle "
                     "row is not zero")
            if not torch.equal(got, again):
                fail(f"paged_decode_attention ({label}, {dt} pool, window "
                     f"{window}): two calls differ")
            errs.append(err)
        # q of the live rows in, every row out, the live pages' K/V, scales
        # and table entries, and last_pos: idle rows only write zeros
        elem, sbytes = POOL_BYTES[dt]
        n_bytes = ((B - len(idle)) * nh * hd * 2 + B * nh * hd * 2
                   + 2 * n_tok * nkv * (hd * elem + sbytes)
                   + n_pages * 4 + B * 4)
        n_ops = 4.0 * nh * hd * n_tok
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: paged_decode_attention_cuda(q, k, v, tbl, lp, ks,
                                                         vs))
        tp = timer.ms(lambda: paged_decode_attention_plain(
            q, k, v, tbl, lp, ks, vs, pp=pp), reps=5)
        lib = timer.ms(lambda: _sdpa(
            torch, q, _gather_dense(torch, k, ks, tbl, P),
            _gather_dense(torch, v, vs, tbl, P), mask))
        say(f"paged decode {label} {dt} pool B={B} H={nh} KV={nkv} hd={hd} "
            f"ps={ps}: max |diff| {errs[0]:.3g} (window {errs[1]:.3g}), two "
            f"calls bit-equal; kernel {t:.4f} ms, plain {tp:.4f} ms, bound "
            f"{b_ms:.5g} ms ({b_by}), gather+SDPA {lib:.4f} ms, floor "
            f"{floor:.4f} ms")
        res[dt] = {"max_abs_err": max(errs), "ms": t, "plain_ms": tp,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return {"shape": f"B={B}, H={nh}, KV={nkv}, hd={hd}, ps={ps}, "
                     f"{n_tok} live tokens, bf16 pool (int8/int4 under "
                     f"'pools')",
            **res["bfloat16"],
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "floor_ms": floor,
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
    pack at every DECODE_SHAPES shape (bf16, int8 and int4 pools, with and
    without a window): within ATTN_ATOL, padding rows exactly zero, two
    calls bit-equal, and a decode-only pack bit-equal to the paged decode
    kernel.  Prints the split plan and the ptxas report (fails on spill);
    times the kernel, the plain version, gather + SDPA and the floor (an
    empty launch of the same grid and cluster) at every shape.  The
    result's top level is qwen2-0.5b's shape; `shapes` holds every
    shape's row."""
    from repro_torch.kernels.paged_attention import decode_plan

    ptxas = decode_ptxas("ragged_decode", "ragged_decode_kernel")
    ps, pps = PAGE_SIZE, 512 // PAGE_SIZE
    plan = decode_plan(pps * ps, ps)
    say(f"ragged plan (table {pps * ps} tokens, ps {ps}): {plan}, grid "
        f"({BUDGET}, KV, {plan.nsplit})")
    shapes = {label: _ragged_at(torch, timer, label, shape)
              for label, shape in DECODE_SHAPES.items()}
    top = shapes["qwen2-0.5b"]
    return {**top,
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "ptxas": ptxas, "shapes": shapes}


def _ragged_at(torch, timer, label, shape):
    """`check_ragged` at one (H, KV, hd) shape."""
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        decode_floor_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.ragged_attention import (
        ragged_decode_attention_cuda, ragged_decode_attention_plain)

    nh, nkv, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    ps = PAGE_SIZE
    P, pps = 320, 512 // PAGE_SIZE
    slot, pos, row_last = _ragged_pack(torch)
    T = slot.shape[0]
    floor = timer.ms(lambda: decode_floor_cuda(T, nkv, ps, pps,
                                               torch.device("cuda")))
    tbl = _table(torch, gen, len(row_last), P, pps, row_last)
    q = torch.randn((T, nh, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    pools = _pools(torch, gen, P, ps, nkv, hd)
    pp = max(1, attn_default_blocks("attn.ragged", T, pps * ps, nh * hd,
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
        errs = []
        for window in (0, 40):
            got = ragged_decode_attention_cuda(q, k, v, tbl, slot, pos, ks,
                                               vs, window=window)
            again = ragged_decode_attention_cuda(q, k, v, tbl, slot, pos, ks,
                                                 vs, window=window)
            want = ragged_decode_attention_plain(q, k, v, tbl, slot, pos, ks,
                                                 vs, window=window, pp=pp)
            err = (got.float() - want.float()).abs().max().item()
            if err > ATTN_ATOL or not torch.all(got[pad] == 0):
                fail(f"ragged_decode_attention ({label}, {dt} pool, window "
                     f"{window}): max |diff| {err} > {ATTN_ATOL} or a "
                     "padding row is not exactly zero")
            if not torch.equal(got, again):
                fail(f"ragged_decode_attention ({label}, {dt} pool, window "
                     f"{window}): two calls differ")
            # a decode-only pack: the paged decode kernel's output, bit for
            # bit
            dec_rows = ragged_decode_attention_cuda(
                q[:n_dec].contiguous(), k, v, tbl, slot[:n_dec].contiguous(),
                pos[:n_dec].contiguous(), ks, vs, window=window)
            paged = paged_decode_attention_cuda(
                q[:n_dec].contiguous(), k, v, tbl[:n_dec].contiguous(),
                pos[:n_dec].contiguous(), ks, vs, window=window)
            if not torch.equal(dec_rows, paged):
                fail(f"ragged_decode_attention ({label}, {dt} pool, window "
                     f"{window}): a decode-only pack differs from the paged "
                     "decode kernel's output (max |diff| "
                     f"{(dec_rows.float() - paged.float()).abs().max()})")
            errs.append(err)
        # q of the live rows in, every row out, each live page's K/V, scales
        # and table entry once, and slot/pos: padding rows only write zeros
        elem, sbytes = POOL_BYTES[dt]
        n_bytes = (n_live * nh * hd * 2 + T * nh * hd * 2
                   + 2 * live_tok * nkv * (hd * elem + sbytes)
                   + n_pages * 4 + T * 4 * 2)
        n_ops = 4.0 * nh * hd * pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: ragged_decode_attention_cuda(q, k, v, tbl, slot,
                                                          pos, ks, vs))
        tp = timer.ms(lambda: ragged_decode_attention_plain(
            q, k, v, tbl, slot, pos, ks, vs, pp=pp), reps=5)
        lib = timer.ms(lambda: _sdpa(
            torch, q, _gather_dense(torch, k, ks, rows, P),
            _gather_dense(torch, v, vs, rows, P), mask))
        say(f"ragged {label} {dt} pool T={T} ({n_dec} decode rows, one "
            f"{int((slot == n_dec).sum())}-row chunk, {int(pad.sum())} "
            f"padding) H={nh} KV={nkv} hd={hd} ps={ps}: max |diff| "
            f"{errs[0]:.3g} (window {errs[1]:.3g}), two calls bit-equal, "
            f"decode-only pack == paged decode; kernel {t:.4f} ms, plain "
            f"{tp:.4f} ms, bound {b_ms:.5g} ms ({b_by}), gather+SDPA "
            f"{lib:.4f} ms, floor {floor:.4f} ms")
        res[dt] = {"max_abs_err": max(errs), "ms": t, "plain_ms": tp,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return {"shape": f"T={T}: {n_dec} decode rows, a 48-row prefill chunk, "
                     f"{int(pad.sum())} padding; H={nh}, KV={nkv}, hd={hd}, "
                     f"ps={ps}, int8 pool (bf16/int4 under 'pools')",
            **res["int8"],
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "floor_ms": floor,
            "pools": {dt: res[dt] for dt in ("bfloat16", "int4")}}


#: flash prefill's timed shapes: (Sq, Skv, real queries, prefix hit, heads,
#: KV heads, head dim).  The fresh prefills are the Poisson trace's prompt
#: buckets (32, 128, 256 holding 32, 96 and 200 real tokens, left-padded);
#: the tail is 64 suffix queries over a gathered 512-slot cache after a
#: 160-token prefix hit; hd128 is qwen3-4b's attention (32 heads over 8 KV
#: heads) on the 256 bucket, hd128_12x2 qwen2-vl-2b's (12 over 2, G = 6)
#: and hd128_48x8 internlm2-20b's (48 over 8, G = 6); hd256
#: recurrentgemma-9b's (16 heads over 1, G = 16) on the 256 bucket and on
#: the tail, where the window (48) masks most of the 512 keys (at serving
#: its 2048 window never bites at max_ctx 512)
FLASH_CASES = {"fresh32": (32, 32, 32, 0, H, KV, HD),
               "fresh128": (128, 128, 96, 0, H, KV, HD),
               "fresh256": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, H, KV, HD),
               "tail": (64, 512, 50, 160, H, KV, HD),
               "hd128": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, 32, 8, 128),
               "hd128_12x2": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, 12, 2,
                              128),
               "hd128_48x8": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, 48, 8,
                              128),
               "hd256": (PROMPT_BUCKET, PROMPT_BUCKET, 200, 0, 16, 1, 256),
               "hd256_tail": (64, 512, 50, 160, 16, 1, 256)}
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
    registers, spill and static shared memory of each instantiation (any
    spill fails), and runs the SASS gate (HMMA in every flash kernel).
    Times the kernel, the plain version and SDPA (GQA expanded) at every
    shape.  The result's top level is fresh256, the main path's largest
    prefill; `shapes` holds every shape's row."""
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
        if spill:
            fail(f"flash: {name} spills {spill} bytes")
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
            "sass_kernels_checked": n_sass,
            "ptxas": {name: {"registers": r, "spill_bytes": sp}
                      for name, (r, sp, _) in sorted(ptxas.items())},
            "shapes": out}


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
    # shared-prefix traffic: prefix hits, the tail prefill over a cached
    # prefix (flash over the gathered pages) under capture
    "prefix_bucketed": ("bucketed", "bfloat16",
                        {"quant_backend": "w4a4_packed"},
                        ("int4_matmul_fused", "flash_prefill",
                         "paged_decode_attention"),
                        ("ragged_decode_attention", "w4a16_matmul",
                         "lut4_matmul")),
    "prefix_ragged": ("ragged", "bfloat16", {"quant_backend": "w4a4_packed"},
                      ("int4_matmul_fused", "ragged_decode_attention"),
                      ("flash_prefill", "paged_decode_attention",
                       "w4a16_matmul", "lut4_matmul")),
}
#: the GEMM each serve run's projections go through (`gemms_a_block`
#: launches a block a forward)
RUN_GEMM = {"bucketed": "int4_matmul_fused", "ragged": "int4_matmul_fused",
            "w4a16": "w4a16_matmul", "lut4": "lut4_matmul",
            "prefix_bucketed": "int4_matmul_fused",
            "prefix_ragged": "int4_matmul_fused",
            "contiguous": "int4_matmul_fused", "mamba": "int4_matmul_fused",
            "hybrid": "int4_matmul_fused", "dense": "int4_matmul_fused"}
def gemms_a_block(bt: str, cfg) -> int:
    """GEMM launches of one block a forward: Mamba-2 2 (in_proj,
    out_proj); attention 4 (wq, wk, wv, wo) or RG-LRU 5 (in_x, in_g, w_a,
    w_x, out), then its FFN, 3 for SwiGLU (w_in, w_gate, w_out) and 2 for
    GELU; an MoE block's attention, then its shared expert or dense
    residual FFN (its experts are batched GEMMs outside the kernel)."""
    if bt == "M":
        return 2
    ffn = 3 if cfg.ffn_type == "swiglu" else 2
    mixer = 4 if bt == "A" else 5
    if bt == "A" and cfg.family == "moe":
        return mixer + ffn * (bool(cfg.shared_expert) + bool(cfg.moe_dense_ff))
    return mixer + (ffn if cfg.d_ff else 0)


def gemms_a_forward(cfg) -> int:
    """The GEMM launches of one forward of `cfg`'s stack (recurrentgemma-9b
    at 38 layers: 26 x 8 + 12 x 7 = 292)."""
    blocks = tuple(cfg.pattern) * cfg.n_repeats + tuple(cfg.tail)
    return sum(gemms_a_block(bt, cfg) for bt in blocks)


#: the decode attention kernel of the runs that launch none: the
#: contiguous layout attends with PyTorch ops (exact attention over the
#: row, as the JAX package's XLA path; recurrentgemma-9b's attention
#: layers too), mamba2-130m has no attention
NO_DECODE_KERNEL = ("contiguous", "mamba", "hybrid")
#: the device kernels behind each GEMM wrapper, by a prefix of their name
#: (the W4A16 wrapper's M <= 16 path and the lut4 wrapper's split calls
#: launch two: split K, then reduce)
GEMM_KERNELS = {"int4_matmul_fused": "w4a4_",
                "w4a16_matmul": "w4a16_", "lut4_matmul": "lut4_"}
#: the attention kernels
ATTN_KERNELS = ("flash_prefill", "paged_decode_attention",
                "ragged_decode_attention")


def eager_engine(*args, **kwargs):
    """An InferenceEngine on cuda whose steps run eagerly, one launch per
    op, as on the CPU: the run the captured steps are compared with."""
    from unittest import mock

    from repro_torch.serving.engine import InferenceEngine

    with mock.patch.object(InferenceEngine, "_capture_steps",
                           lambda *a: None):
        return InferenceEngine(*args, **kwargs)


def serve_engine(torch, cfg, params, rt, sv, trace, warm_lens, label: str,
                 eager=False, telemetry=None):
    """Serve `trace` through InferenceEngine on cuda under `rt` and `sv`,
    its steps captured (or eager, with `eager`), with `telemetry` (a new
    bundle by default); checks every request (ok, its tokens in [0,
    vocab)), the devices of every tensor and, for the captured steps, that
    no shape was captured twice.  Launches are counted from 0 just before
    the run.  Prints the run's numbers under `label`.  Returns (engine,
    launches, stats, tokens by request id)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import run_trace
    from repro_torch.serving.engine import InferenceEngine

    make = eager_engine if eager else InferenceEngine
    engine = make(cfg, rt, sv, params=params, device="cuda",
                  telemetry=telemetry)
    for tree, what in ((engine.params, "parameter"), (engine.caches, "cache")):
        cpu = [t for t in _tensors(tree) if t.device.type != "cuda"]
        if cpu:
            fail(f"serve ({label}): {len(cpu)} {what} tensors are not on the "
                 "card")
    engine.warmup(warm_lens)
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
    budget = (f", token budget {stats['token_budget']}, padding rows "
              f"{stats['padding_tokens_wasted']}" if sv.step == "ragged"
              else "")
    say(f"serve ({label}: {sv.layout}, {sv.step}, {rt.cache_dtype} cache, "
        f"{rt.quant_plan or rt.quant_backend}, {rt.attn_impl} prefill): "
        f"{len(finished)} requests ok, "
        f"{stats['decode_tokens']} decode tokens in {stats['wall_s']:.2f} s = "
        f"{stats['decode_tok_per_s']:.1f} tok/s; latency p50 "
        f"{stats['latency_p50_s']:.3f} s, p95 {stats['latency_p95_s']:.3f} s; "
        f"ttft p50 {stats['ttft_p50_s']:.3f} s; steps {stats['steps']} "
        f"(mean {stats['wall_s'] / stats['steps'] * 1e3:.1f} ms), preempted "
        f"{stats['requests_preempted']}, prefill tokens "
        f"{stats['prefill_tokens']}, prefix-hit tokens "
        f"{stats['tokens_prefilled_saved']} (hit rate "
        f"{stats['prefix_hit_rate']:.3f}){budget}")
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


def serve_run(torch, params, run: str, trace, prompt_lens, eager=False,
              prefix_cache=True, telemetry=None):
    """Serve `trace` on full-width qwen2-0.5b (`serve_engine`) as serve run
    `run` of SERVE_RUNS, its steps captured (or eager, with `eager`), the
    prefix cache on unless `prefix_cache` is false; checks also the
    launches of the path: its kernels launched, the other paths' never,
    its GEMM 7 times per layer per forward.  The model has RUN_LAYERS'
    depth for `run` (LAYERS by default).  Returns (engine, launches,
    stats, tokens by request id)."""
    from repro_torch.configs import Runtime, ServingConfig, get_config

    step, cache_dtype, quant, must, must_not = SERVE_RUNS[run]
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              n_layers=RUN_LAYERS.get(run, LAYERS))
    rt = Runtime(attn_impl="flash", cache_dtype=cache_dtype, **quant)
    sv = ServingConfig(layout="paged", max_batch=MAX_BATCH,
                       page_size=PAGE_SIZE, num_pages=320, max_ctx=512,
                       prefix_cache=prefix_cache, step=step)
    label = (f"{run}, {'eager' if eager else 'graphs'}"
             + ("" if prefix_cache else ", prefix cache off"))
    engine, launches, stats, tokens = serve_engine(
        torch, cfg, params, rt, sv, trace, prompt_lens, label, eager=eager,
        telemetry=telemetry)
    _check_launches(label, launches, must, must_not, RUN_GEMM[run],
                    7 * cfg.n_layers)
    return engine, launches, stats, tokens


def _check_launches(label, launches, must, must_not, gemm, per_forward):
    """Fail unless every kernel of `must` launched, none of `must_not`, and
    `gemm` a multiple of `per_forward` times."""
    for name in must:
        if launches[name] <= 0:
            fail(f"serve ({label}): kernel {name} was never launched on the "
                 "path")
    for name in must_not:
        if launches[name] != 0:
            fail(f"serve ({label}): {name} launched {launches[name]} times "
                 "on a path that does not run it")
    if launches[gemm] % per_forward:
        fail(f"serve ({label}): {gemm} launched {launches[gemm]} times, not "
             f"{per_forward} per forward")


#: the shared-prefix trace of phase 4: 8 requests, one 128-token system
#: prompt and a 32- or 96-token user suffix each, 16 or 32 new tokens
PREFIX_TRACE = dict(n_requests=8, rate_per_step=0.5, sys_len=128,
                    user_lens=(32, 96), gen_lens=(16, 32))


def check_trace_json(path: str, n_slots: int) -> int:
    """Load a saved trace recorder file as Chrome trace_event JSON; fail
    unless it names an engine lane and one lane per batch slot and holds
    step, prefill, tail prefill and request residency spans.  Returns its
    event count."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    want = {0: "engine", **{1 + s: f"slot{s}" for s in range(n_slots)}}
    if lanes != want:
        fail(f"trace: lanes {lanes}, want the engine and {n_slots} slots")
    names = {e["name"] for e in events if e.get("ph") == "X"}
    missing = {"step", "prefill", "tail_prefill"} - names
    if missing or not any(n.startswith("r") and n[1:].isdigit()
                          for n in names):
        fail(f"trace: no {sorted(missing) or 'request residency'} spans "
             f"among {sorted(names)[:12]}")
    if doc["otherData"]["dropped_events"]:
        fail(f"trace: {doc['otherData']['dropped_events']} events dropped")
    return len(events)


def prefix_runs(torch):
    """Shared-prefix traffic (PREFIX_TRACE) on the bucketed and the ragged
    step, bf16 pool, W4A4 weights at RUN_LAYERS' depth: each served with
    captured steps, with
    eager steps and, captured, with the prefix cache off (the cold run).
    Fails unless every request is ok, prefix hits saved prefill tokens,
    the bucketed run captured a tail-prefill shape and launched flash
    prefill, nothing was captured twice, and the captured run's tokens and
    launches equal the eager run's.  Token agreement with the cold run is
    reported, not gated (flash over a cached prefix tiles the context
    differently from a fresh prefill, and bf16 W4A4 amplifies a rounding
    difference).  The bucketed captured run records the trace recorder's
    timeline to a temporary file, checked by `check_trace_json`.  Returns
    the captured runs' launches."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.observability import Telemetry
    from repro_torch.serving.api import shared_prefix_trace

    trace = shared_prefix_trace(**PREFIX_TRACE,
                                vocab=get_config("qwen2-0.5b").vocab,
                                seed=SEED)
    params = _w4a4_params(RUN_LAYERS["prefix_bucketed"])
    sys_len = PREFIX_TRACE["sys_len"]
    warm = PREFIX_TRACE["user_lens"] + tuple(sys_len + u for u in
                                            PREFIX_TRACE["user_lens"])
    launches = []
    for run in ("prefix_bucketed", "prefix_ragged"):
        t0 = time.perf_counter()
        tm = Telemetry(trace=True) if run == "prefix_bucketed" else None
        engine, n, stats, tokens = serve_run(torch, params, run, trace, warm,
                                             telemetry=tm)
        del engine
        _, n_eager, _, eager = serve_run(torch, params, run, trace, warm,
                                         eager=True)
        _, _, cold_stats, cold = serve_run(torch, params, run, trace, warm,
                                           prefix_cache=False)
        launches.append(n)
        if stats["tokens_prefilled_saved"] <= 0:
            fail(f"serve ({run}): no prefix-hit tokens on shared-prefix "
                 "traffic")
        by_fn = stats["recompiles"]["by_fn"]
        if run == "prefix_bucketed" and by_fn.get("prefill_tail", 0) < 1:
            fail(f"serve ({run}): no prefill_tail shape captured "
                 f"({json.dumps(by_fn)})")
        if eager != tokens or n_eager != n:
            diff = [r for r in eager if tokens.get(r) != eager[r]]
            fail(f"serve ({run}): captured vs eager: requests {diff} differ "
                 f"in tokens, launches {json.dumps(n)} vs "
                 f"{json.dumps(n_eager)}")
        same = sum(tokens[r] == cold[r] for r in tokens)
        first = sum(tokens[r][0] == cold[r][0] for r in tokens)
        say(f"serve ({run}): every request's tokens and the kernel launches "
            "equal the eager run's; prefix on vs off: "
            f"{stats['decode_tok_per_s']:.1f} vs "
            f"{cold_stats['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
            f"{stats['ttft_p50_s'] * 1e3:.2f} vs "
            f"{cold_stats['ttft_p50_s'] * 1e3:.2f} ms, hit rate "
            f"{stats['prefix_hit_rate']:.3f} vs "
            f"{cold_stats['prefix_hit_rate']:.3f}, prefill tokens "
            f"{stats['prefill_tokens']} vs {cold_stats['prefill_tokens']}; "
            f"{same} of {len(tokens)} requests emit the cold run's tokens "
            f"({first} its first token); "
            f"captures {json.dumps(by_fn)}")
        if tm is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                tm.trace.save(path)
                n_events = check_trace_json(path, MAX_BATCH)
            finally:
                os.unlink(path)
            say(f"trace ({run}): Chrome trace JSON with the engine lane and "
                f"{MAX_BATCH} slot lanes, {n_events} events")
        say(f"serve ({run}): three runs in "
            f"{time.perf_counter() - t0:.1f} s")
    return {k: sum(n[k] for n in launches) for k in launches[0]}


#: the chaos runs of phase 4: (step mode, chaos preset keywords or None for
#: CANCEL_STORM)
CHAOS_RUNS = (("bucketed", {"seed": 0, "stop_resume_at": (6, 14)}),
              ("ragged", {"seed": 0, "stop_resume_at": (6, 14)}),
              ("bucketed", None))
#: the largest growth of memory_allocated from one restored engine to the
#: next that still reads as flat: per-graph static buffers are ~KB, a
#: leaked engine its 63 MB pool
RESTORE_SLACK_BYTES = 1 << 20


def chaos_runs(torch):
    """The chaos harness (`serving.chaos.run_chaos`) at full width on the
    card (RUN_LAYERS' depth), bf16 pool, W4A4 weights, exact-softmax
    prefill as the CLI runs
    it: seed 0 with a snapshot/restore at steps 6 and 14, bucketed and
    ragged, and CANCEL_STORM bucketed.  Each run is held to a fault-free
    reference of its own step mode (the ragged kernel's online softmax and
    the bucketed exact prefill round differently).  run_chaos asserts the
    invariants after every event, zero leaked pages, an outcome for every
    request and survivors equal to the reference; here the memory
    allocated on the card, read at each snapshot (one engine alive) and
    after the run, must stay flat.  Prints each run's events, outcomes,
    preemptions, the captures of each engine before its restore and the
    memory readings.  Returns the chaos runs' launches."""
    import gc
    from unittest import mock

    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import chaos
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              n_layers=RUN_LAYERS["chaos"])
    params = _w4a4_params(cfg.n_layers)
    rt = Runtime(attn_impl="chunked", attn_chunk_q=512,
                 quant_backend="w4a4_packed", cache_dtype="bfloat16")
    refs, launches = {}, []
    real_snapshot, real_restore = (InferenceEngine.snapshot,
                                   InferenceEngine.restore.__func__)
    for step, knobs in CHAOS_RUNS:
        t0 = time.perf_counter()
        preset = (chaos.CANCEL_STORM if knobs is None
                  else chaos.ChaosConfig(**knobs))
        name = f"{step}, " + ("cancel storm" if knobs is None
                              else f"seed {preset.seed}")
        sv = ServingConfig(layout="paged", max_batch=MAX_BATCH,
                           page_size=PAGE_SIZE, num_pages=320, max_ctx=512,
                           step=step, max_queue=2 * MAX_BATCH)
        trace = chaos._make_trace(preset, cfg.vocab)
        key = (step, preset.seed)
        if key not in refs:
            refs[key] = chaos.reference_tokens(cfg, rt, sv, trace,
                                               params=params, device="cuda")
        readings, held = [], {}

        def snapshot(self):
            gc.collect()
            torch.cuda.synchronize()
            readings.append((torch.cuda.memory_allocated(),
                             self.tm.jit_watch.snapshot()["total"]))
            return real_snapshot(self)

        def restore(cls, *args, **kwargs):
            held["engine"] = real_restore(cls, *args, **kwargs)
            return held["engine"]

        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        try:
            with mock.patch.object(InferenceEngine, "snapshot", snapshot), \
                    mock.patch.object(InferenceEngine, "restore",
                                      classmethod(restore)):
                rep = chaos.run_chaos(cfg, rt, sv, preset, params=params,
                                      reference=refs[key], device="cuda")
        except AssertionError as exc:
            fail(f"chaos ({name}): {exc}")
        torch.cuda.synchronize()
        launches.append(ops.launch_counts())
        last = held.pop("engine", None)
        captures = [c for _, c in readings] + (
            [last.tm.jit_watch.snapshot()["total"]] if last else [])
        del last
        gc.collect()
        after = torch.cuda.memory_allocated()
        mem = [m for m, _ in readings]
        if any(b > mem[0] + RESTORE_SLACK_BYTES for b in mem[1:]) \
                or after > before + RESTORE_SLACK_BYTES:
            fail(f"chaos ({name}): memory allocated grew across restores: "
                 f"before {before}, at each snapshot {mem}, after {after}")
        if rep["recompiles_steady_state"]:
            fail(f"chaos ({name}): {rep['recompiles_steady_state']} "
                 "steady-state recompiles")
        say(f"chaos ({name}): {rep['steps']} steps, events "
            f"{json.dumps(rep['events'])}, outcomes "
            f"{json.dumps(rep['outcomes'])}, {rep['survivors']} survivors "
            f"equal the reference, preemptions {rep['preemptions']}, leaked "
            f"pages {rep['leaked_pages']}, pool high water "
            f"{rep['pool_high_water']}; captures by each engine (restored "
            f"at {list(preset.stop_resume_at)}): {captures}; memory "
            f"allocated before {before}, at each snapshot {mem}, after "
            f"{after} bytes; {time.perf_counter() - t0:.1f} s")
    bucketed, ragged = refs[("bucketed", 0)], refs[("ragged", 0)]
    same = sum(bucketed[r] == ragged[r] for r in bucketed)
    first = sum(bucketed[r][0] == ragged[r][0] for r in bucketed)
    say(f"chaos: the bucketed and ragged references agree on {same} of "
        f"{len(bucketed)} requests, on the first token of {first} "
        "(reported, not gated)")
    return {k: sum(n[k] for n in launches) for k in launches[0]}


# --------------------------------------------- contiguous layout, Mamba ----
#: the Poisson trace of phase 4: 8 requests, prompts 32/96/160/256 tokens,
#: 16/32/64 new tokens, arrivals at 0.5 a step
PROMPT_LENS = (32, 96, 160, 256)
GEN_LENS = (16, 32, 64)
#: the compare harness's pairs that do the same arithmetic, gated equal:
#: exact softmax over the same dense [B, max_ctx] layout, and the fused
#: paged decode with and without prefix sharing (random prompts miss)
COMPARE_GATED = (("contiguous", "paged_gather"), ("paged", "paged_nocache"))


def _sv(layout="paged", **kw):
    """The serving config of every phase-4 run on full-width models."""
    from repro_torch.configs import ServingConfig

    return ServingConfig(layout=layout, max_batch=MAX_BATCH,
                         page_size=PAGE_SIZE, num_pages=320, max_ctx=512,
                         **kw)


def _agreement(tokens, ref):
    """(requests whose tokens equal `ref`'s, requests whose first token
    does)."""
    return (sum(tokens[r] == ref[r] for r in ref),
            sum(tokens[r][0] == ref[r][0] for r in ref))


def contiguous_runs(torch, params, trace):
    """`--layout contiguous` on full-width qwen2-0.5b at RUN_LAYERS' depth
    (`params` at that depth), W4A4 weights, bf16
    cache, flash prefill, the Poisson trace: served captured, then eager;
    every request ok, the fused W4A4 GEMM 7 times a layer a forward, flash
    prefill launched and no decode attention kernel (the row attends with
    PyTorch ops), tokens and launches equal to eager, and tokens equal to
    a `paged_gather` run (both exact softmax over the same dense layout).
    The captured engine's decode steps are profiled.  Returns the captured
    runs' launches."""
    from repro_torch.configs import Runtime, get_config

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              n_layers=RUN_LAYERS["contiguous"])
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="bfloat16")
    must = ("int4_matmul_fused", "flash_prefill")
    must_not = ("paged_decode_attention", "ragged_decode_attention",
                "w4a16_matmul", "lut4_matmul")
    t0 = time.perf_counter()
    runs = {}
    for mode in ("graphs", "eager"):
        label = f"contiguous, {mode}"
        engine, n, stats, tokens = serve_engine(
            torch, cfg, params, rt, _sv("contiguous"), trace, PROMPT_LENS,
            label, eager=mode == "eager")
        _check_launches(label, n, must, must_not, "int4_matmul_fused",
                        7 * cfg.n_layers)
        if mode == "graphs":
            profile_steps(torch, engine, cfg.vocab, "contiguous")
            att = engine.profile()
            say(f"profile (contiguous): engine.profile(): decode step "
                f"{att['decode_step_us']} us, decode attention "
                f"{att['attn_us']} us ({cfg.n_layers} x one call), attn_frac "
                f"{att['attn_frac']}")
        del engine
        runs[mode] = (n, stats, tokens)
    (n, stats, tokens), (n_e, _, eager) = runs["graphs"], runs["eager"]
    if eager != tokens or n_e != n:
        diff = [r for r in eager if tokens.get(r) != eager[r]]
        fail(f"serve (contiguous): captured vs eager: requests {diff} differ "
             f"in tokens, launches {json.dumps(n)} vs {json.dumps(n_e)}")
    _, n_g, _, gather = serve_engine(
        torch, cfg, params, dataclasses.replace(rt, paged_attn="gather"),
        _sv(), trace, PROMPT_LENS, "paged_gather, graphs")
    if gather != tokens:
        diff = [r for r in gather if tokens.get(r) != gather[r]]
        fail(f"serve (contiguous): requests {diff} emit other tokens than "
             "on the paged_gather path (the same exact attention)")
    say("serve (contiguous): every request's tokens and the kernel launches "
        "equal the eager run's, and its tokens the paged_gather run's; "
        f"{time.perf_counter() - t0:.1f} s")
    return {k: n[k] + n_g[k] for k in n}


def compare_runs(torch, params, trace):
    """The compare harness (`launch/serve.py --layout compare`) driven
    path by path: full-width qwen2-0.5b at RUN_LAYERS' depth (`params` at
    that depth), exact-softmax prefill
    (`attn_impl="chunked"`), bf16 cache, the Poisson trace, each of
    COMPARE_PATHS an engine with captured steps, under W4A4 (`params`) and
    again under `--quant-plan "*=float"` (float masters from the same
    seed).  Every path serves 8 of 8 ok; the pairs of COMPARE_GATED must
    emit the same tokens; every other path's agreement with `contiguous`
    is printed, not gated (the fused decode and ragged kernels run an
    online split softmax, and bf16 W4A4 amplifies a rounding difference:
    ROADMAP Queue 3 items 7 and 14).  Returns the runs' launches."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.launch.serve import COMPARE_PATHS, compare_path
    from repro_torch.serving.engine import build_params

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              n_layers=RUN_LAYERS["compare"])
    launches = []
    for plan, kw in (("W4A4", {"quant_backend": "w4a4_packed"}),
                     ("*=float", {"quant_plan": "*=float"})):
        t0 = time.perf_counter()
        rt = Runtime(attn_impl="chunked", attn_chunk_q=512,
                     cache_dtype="bfloat16", **kw)
        weights = params if plan == "W4A4" else build_params(
            cfg, rt, seed=SEED, device="cuda")
        tokens = {}
        for path in COMPARE_PATHS:
            rt_path, sv = compare_path(path, rt, _sv())
            _, n, _, tokens[path] = serve_engine(
                torch, cfg, weights, rt_path, sv, trace, PROMPT_LENS,
                f"compare {plan}, {path}")
            launches.append(n)
        for a, b in COMPARE_GATED:
            if tokens[a] != tokens[b]:
                diff = [r for r in tokens[a]
                        if tokens[b].get(r) != tokens[a][r]]
                fail(f"compare ({plan}): {a} and {b} differ on requests "
                     f"{diff} (the same arithmetic)")
        agree = {p: _agreement(tokens[p], tokens["contiguous"])
                 for p in COMPARE_PATHS if p != "contiguous"}
        gated = " and ".join(f"{a} = {b}" for a, b in COMPARE_GATED)
        say(f"compare ({plan}): {gated} token for token; agreement with "
            "contiguous (requests, first tokens, of 8): "
            + ", ".join(f"{p} {a}/{f}" for p, (a, f) in agree.items())
            + f"; {time.perf_counter() - t0:.1f} s")
        del weights
    return {k: sum(n[k] for n in launches) for k in launches[0]}


#: mamba2-130m's projections: (K, N) of in_proj (2 * 1536 + 2 * 128 + 24
#: columns) and out_proj, one of each a layer
MAMBA_GEMM_SHAPES = (((768, 3352), 1), ((1536, 768), 1))


def mamba_runs(torch):
    """Full-width mamba2-130m (24 layers, d_model 768, 24 SSD heads of 64,
    state 128, vocab 50280; random weights from SEED), W4A4-packed in_proj
    and out_proj, the tied float embedding as lm_head, served through the
    contiguous layout (its default) on the Poisson trace with exact-length
    prefill: captured, then eager.  Every request ok with tokens in [0,
    50280), the fused W4A4 GEMM 2 times a layer a forward, no attention
    kernel, captured tokens and launches equal to eager, one captured
    graph per prompt length and decode bucket, none twice.  The captured
    engine's decode steps are profiled.  Returns the captured run's
    launches."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.serving.api import poisson_trace
    from repro_torch.serving.engine import build_params

    cfg = get_config("mamba2-130m")
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
    t0 = time.perf_counter()
    params = build_params(cfg, rt, seed=SEED, device="cuda")
    packed = [k for k in ("in_proj", "out_proj")
              if "packed" in params["layers"]["u0"]["mamba"][k]]
    if packed != ["in_proj", "out_proj"]:
        fail(f"mamba: only {packed} of in_proj, out_proj were pre-packed")
    say(f"mamba: built full-width {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm_headdim}, state {cfg.ssm_state}, vocab {cfg.vocab}) in "
        f"{time.perf_counter() - t0:.1f} s")
    trace = poisson_trace(8, 0.5, PROMPT_LENS, GEN_LENS, cfg.vocab,
                          seed=SEED)
    lens = sorted({len(it.prompt) for it in trace})
    runs = {}
    for mode in ("graphs", "eager"):
        label = f"mamba, {mode}"
        engine, n, stats, tokens = serve_engine(
            torch, cfg, params, rt, _sv("contiguous"), trace, PROMPT_LENS,
            label, eager=mode == "eager")
        _check_launches(label, n, ("int4_matmul_fused",),
                        ATTN_KERNELS + ("w4a16_matmul", "lut4_matmul"),
                        "int4_matmul_fused", 2 * cfg.n_layers)
        if mode == "graphs":
            by_fn = stats["recompiles"]["by_fn"]
            want = {"prefill": len(PROMPT_LENS),
                    "decode": len(_sv().buckets)}
            if by_fn != want or engine._prefill._cache_size() != \
                    len(PROMPT_LENS):
                fail(f"serve ({label}): captures {json.dumps(by_fn)}, want "
                     f"one a prompt length and a decode bucket "
                     f"{json.dumps(want)}")
            prof = profile_steps(torch, engine, cfg.vocab, "mamba")
            say(f"serve ({label}): prompt lengths {lens}, one prefill graph "
                f"each; decode step {prof['ms']:.3f} ms "
                f"({prof.get('replay_ms', float('nan')):.3f} ms a replay)")
        del engine
        runs[mode] = (n, tokens)
    (n, tokens), (n_e, eager) = runs["graphs"], runs["eager"]
    if eager != tokens or n_e != n:
        diff = [r for r in eager if tokens.get(r) != eager[r]]
        fail(f"serve (mamba): captured vs eager: requests {diff} differ in "
             f"tokens, launches {json.dumps(n)} vs {json.dumps(n_e)}")
    say("serve (mamba): every request's tokens and the kernel launches equal "
        f"the eager run's; {time.perf_counter() - t0:.1f} s")
    return n


#: recurrentgemma-9b's served depth: all 38 layers, (R, R, A) x 12 and the
#: (R, R) tail (a cut must keep 2 + 3k)
HYBRID_LAYERS = 38


def hybrid_runs(torch):
    """Full-width recurrentgemma-9b (HYBRID_LAYERS layers of (R, R, A)
    units and an (R, R) tail, d_model 4096, RG-LRU width 4096, 16 heads
    over 1 KV head at head dim 256, window 2048, d_ff 12288, vocab 256000;
    random weights from SEED), W4A4-packed projections, the untied lm_head
    float (the plan's default), served through the contiguous layout (its
    default) on the Poisson trace with exact-length prefill and flash
    prefill at hd 256: captured, then eager.  Prints the build's time and
    the card's peak memory.  Every request ok with tokens in [0, 256000),
    the fused W4A4 GEMM 8 times an R layer and 7 an A layer a forward,
    flash prefill once an attention layer a prefill, no decode attention,
    W4A16 or lut4 kernel, captured tokens and launches equal to eager, one
    captured graph per prompt length and decode bucket, none twice.  The
    captured engine's decode steps are profiled.  Returns the captured
    run's launches."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.serving.api import poisson_trace
    from repro_torch.serving.engine import build_params

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=HYBRID_LAYERS)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = build_params(cfg, rt, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    lru = ("in_x", "in_g", "w_a", "w_x", "out")
    blocks = [params["layers"]["u0"], params["layers"]["u1"],
              params["tail0"], params["tail1"]]
    unpacked = [k for b in blocks for k in lru if "packed" not in b["lru"][k]]
    unpacked += [k for k in ("wq", "wk", "wv", "wo")
                 if "packed" not in params["layers"]["u2"]["attn"][k]]
    if unpacked or isinstance(params["lm_head"]["w"], dict):
        fail(f"hybrid: {unpacked} were not pre-packed, or the lm_head was")
    n_attn = sum(bt == "A" for bt in cfg.pattern) * cfg.n_repeats
    per_forward = gemms_a_forward(cfg)
    say(f"hybrid: built full-width {cfg.name} ({cfg.n_layers} layers: "
        f"{cfg.n_layers - n_attn} RG-LRU, {n_attn} attention; d_model "
        f"{cfg.d_model}, lru_width {cfg.lru_width}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} at hd {cfg.hd}, window {cfg.local_window}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}) in {build_s:.1f} s; the card's peak "
        f"during the build {peak / 2**30:.2f} GiB, held after it "
        f"{held / 2**30:.2f} GiB")
    trace = poisson_trace(8, 0.5, PROMPT_LENS, GEN_LENS, cfg.vocab,
                          seed=SEED)
    lens = sorted({len(it.prompt) for it in trace})
    runs = {}
    for mode in ("graphs", "eager"):
        label = f"hybrid, {mode}"
        engine, n, stats, tokens = serve_engine(
            torch, cfg, params, rt, _sv("contiguous"), trace, PROMPT_LENS,
            label, eager=mode == "eager")
        _check_launches(label, n, ("int4_matmul_fused", "flash_prefill"),
                        ("paged_decode_attention", "ragged_decode_attention",
                         "w4a16_matmul", "lut4_matmul"),
                        "int4_matmul_fused", per_forward)
        if n["flash_prefill"] != n_attn * len(trace):
            fail(f"serve ({label}): flash_prefill launched "
                 f"{n['flash_prefill']} times, want {n_attn} a prefill")
        if mode == "graphs":
            by_fn = stats["recompiles"]["by_fn"]
            want = {"prefill": len(PROMPT_LENS),
                    "decode": len(_sv().buckets)}
            if by_fn != want or engine._prefill._cache_size() != \
                    len(PROMPT_LENS):
                fail(f"serve ({label}): captures {json.dumps(by_fn)}, want "
                     f"one a prompt length and a decode bucket "
                     f"{json.dumps(want)}")
            prof = profile_steps(torch, engine, cfg.vocab, "hybrid")
            att = engine.profile()
            say(f"serve ({label}): prompt lengths {lens}, one prefill graph "
                f"each; decode step {prof['ms']:.3f} ms "
                f"({prof.get('replay_ms', float('nan')):.3f} ms a replay); "
                f"engine.profile(): decode step {att['decode_step_us']} us, "
                f"decode attention {att['attn_us']} us ({n_attn} x one "
                f"call), attn_frac {att['attn_frac']}")
        del engine
        runs[mode] = (n, tokens)
    (n, tokens), (n_e, eager) = runs["graphs"], runs["eager"]
    if eager != tokens or n_e != n:
        diff = [r for r in eager if tokens.get(r) != eager[r]]
        fail(f"serve (hybrid): captured vs eager: requests {diff} differ in "
             f"tokens, launches {json.dumps(n)} vs {json.dumps(n_e)}")
    say("serve (hybrid): every request's tokens and the kernel launches "
        f"equal the eager run's; {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return n


#: the paged configs served in phase 4 at full width: their depth
#: (RUN_LAYERS cuts the MoE configs) and whether the run also serves the
#: ragged step on an int8 pool and profiles its captured decode step
DENSE_RUNS = (("qwen3-4b", True), ("qwen2-vl-2b", False),
              ("internlm2-20b", False), ("starcoder2-7b", False),
              ("musicgen-large", False), ("arctic-480b", False),
              ("llama4-maverick-400b-a17b", False))


def _dense_launches(label, n, step, layers, per_layer):
    """The paged runs' launch gates: the W4A4 GEMM `per_layer` times a
    layer a forward (`gemms_a_block`); bucketed: flash prefill once a
    layer a prefill and paged decode once a layer a decode step (every
    forward is one or the other: the two counts together are the GEMM's
    over `per_layer`), no ragged kernel; ragged: the ragged kernel once a
    layer a step, no flash or paged decode; never the W4A16 or lut4
    GEMMs."""
    gemm = n["int4_matmul_fused"]
    if step == "bucketed":
        must = ("int4_matmul_fused", "flash_prefill", "paged_decode_attention")
        must_not = ("ragged_decode_attention", "w4a16_matmul", "lut4_matmul")
        attn = n["flash_prefill"] + n["paged_decode_attention"]
        per = (n["flash_prefill"] % layers, n["paged_decode_attention"]
               % layers)
    else:
        must = ("int4_matmul_fused", "ragged_decode_attention")
        must_not = ("flash_prefill", "paged_decode_attention",
                    "w4a16_matmul", "lut4_matmul")
        attn = n["ragged_decode_attention"]
        per = (attn % layers,)
    _check_launches(label, n, must, must_not, "int4_matmul_fused",
                    per_layer * layers)
    if any(per) or per_layer * attn != gemm:
        fail(f"serve ({label}): attention launches {json.dumps(n)} are not "
             f"one a layer a forward ({gemm // (per_layer * layers)} "
             f"forwards of {layers} layers)")
    return gemm // (per_layer * layers)


def _first_layers(params, n: int):
    """The first `n` layers of a stacked parameter tree (views)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "layers": cut(params["layers"])}


def _unpacked(block) -> list:
    """The projections of one block that the W4A4 plan left unpacked: the
    attention's, the FFN's, an MoE block's shared or dense FFN's, and its
    expert stacks (packed per channel, without a K-major twin)."""
    out = [f"attn.{k}" for k in ("wq", "wk", "wv", "wo")
           if "packed" not in block["attn"][k]]
    for side in ("ffn", "shared", "dense_ffn"):
        out += [f"{side}.{k}" for k, w in block.get(side, {}).items()
                if k.startswith("w_") and "packed" not in w]
    if "moe" in block:
        out += [f"moe.experts.{k}"
                for k, w in block["moe"]["experts"].items()
                if "packed" not in w or "packed_km" in w]
    return out


def moe_two_calls(torch, timer, cfg, block, rt):
    """The MoE block of layer 0 at full width on the card (`apply_moe`, the
    serving path's bf16 activations), twice on the same inputs: at a decode
    batch (MAX_BATCH rows: only the experts its tokens route to run) and
    at a prefill (2 x PROMPT_BUCKET rows: every expert runs).  Fails unless
    the two calls are bit-equal and finite; prints the experts that took a
    token, the tokens dropped past capacity and the block's time."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    p = block["moe"]
    for B, S in ((MAX_BATCH, 1), (2, PROMPT_BUCKET)):
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        route = {}

        def call():
            return moe.apply_moe(p, x, cfg, rt, site="block[0].moe")
        with torch.inference_mode():
            a, b = call(), call()
            moe._moe_shard(x.reshape(B * S, -1), p["router"]["w"],
                           p["experts"], e_start=0, n_local=cfg.n_experts,
                           cfg=cfg, rt=rt, site="block[0].moe",
                           dispatch=route)
            ms = timer.ms(call, reps=5, warmup=1)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"moe ({cfg.name}, {B} x {S}): two calls on the same inputs "
                 "differ")
        if not torch.isfinite(a[0].float()).all():
            fail(f"moe ({cfg.name}, {B} x {S}): non-finite output")
        T = B * S
        used = route["idx"].unique().numel()
        dropped = int((~route["local"]).sum())
        say(f"moe ({cfg.name}): {B} x {S} rows, top-{cfg.top_k} of "
            f"{cfg.n_experts}, capacity {moe._capacity(T, cfg)}: two calls "
            f"bit-equal; {used} experts took a token, "
            f"{min(T * cfg.top_k, cfg.n_experts)} ran, {dropped} of "
            f"{T * cfg.top_k} assignments dropped; {ms:.3f} ms a call")


def dense_runs(torch):
    """The paged configs at full width (random weights from SEED),
    W4A4-packed projections, served through the paged layout on the
    Poisson trace (page 16, max_ctx 512, max batch 8, flash prefill, bf16
    pool, the bucketed step): qwen3-4b (36 layers, qk_norm, 32 heads over
    8, untied float lm_head), qwen2-vl-2b (M-RoPE on the text
    positions, 12 heads over 2, qkv bias, tied embeddings), internlm2-20b
    (24 of 48 layers, 48 heads over 8, d_model 6144), starcoder2-7b (32 layers,
    GELU FFN with biases, qkv bias, 36 heads over 4), musicgen-large (48
    layers, sinusoidal positions, 32 heads over 32 at hd 64, vocab 2048),
    arctic-480b (top-2 of 128 experts beside a dense residual FFN, 56
    heads over 8) and llama4-maverick (top-1 of 128 beside a shared
    expert, 40 heads over 8), the MoE configs, qwen2-vl-2b and
    internlm2-20b cut to RUN_LAYERS' depth.
    Each run captured, then eager: every request ok with tokens in [0,
    vocab), launches per `_dense_launches` (the W4A4 GEMM 7 times a layer
    a forward, 6 for the GELU configs), captured tokens and launches
    equal to eager.  qwen3-4b also serves the mixed trace on the ragged
    step with an int8 pool on its first RUN_LAYERS["qwen3-4b ragged"]
    layers (captured, then eager) and `profile_steps` runs
    on its captured bucketed decode step; the MoE configs' layer-0 block
    is held two calls bit-equal first (`moe_two_calls`).  Prints each
    build's time, the card's peak memory during it and what it holds
    after.  Returns the captured runs' launches, summed."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.core.quant_plan import layer_slice
    from repro_torch.serving.api import mixed_trace, poisson_trace
    from repro_torch.serving.engine import build_params

    launches = []
    for arch, more in DENSE_RUNS:
        t0 = time.perf_counter()
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=RUN_LAYERS.get(
            arch, base.n_layers))
        rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                     cache_dtype="bfloat16")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        params = build_params(cfg, rt, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        held = torch.cuda.memory_allocated() - mem0
        unpacked = _unpacked(params["layers"]["u0"])
        if unpacked:
            fail(f"dense ({arch}): {unpacked} were not pre-packed")
        per_layer = gemms_a_block("A", cfg)
        moe_txt = (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
                   f"{cfg.d_ff_expert}, shared {cfg.shared_expert}, dense "
                   f"FFN {cfg.moe_dense_ff}" if cfg.family == "moe" else "")
        say(f"dense: built full-width {arch} ({cfg.n_layers} of "
            f"{base.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
            f"heads over {cfg.n_kv_heads} at hd {cfg.hd}, d_ff {cfg.d_ff} "
            f"{cfg.ffn_type}, mlp bias {cfg.mlp_bias}, vocab {cfg.vocab}, "
            f"qk_norm {cfg.qk_norm}, rope {cfg.rope}, tied "
            f"{cfg.tie_embeddings}{moe_txt}; {per_layer} GEMMs a layer) in "
            f"{build_s:.1f} s; the card's peak during the build "
            f"{peak / 2**30:.2f} GiB, held after it {held / 2**30:.2f} GiB")
        if cfg.family == "moe":
            moe_two_calls(torch, Timer(torch), cfg,
                          layer_slice(params["layers"]["u0"], 0), rt)
        runs = [("bucketed", "bfloat16", poisson_trace(
            8, 0.5, PROMPT_LENS, GEN_LENS, cfg.vocab, seed=SEED), cfg,
            params)]
        if more:
            n_cut = RUN_LAYERS[f"{arch} ragged"]
            runs.append(("ragged", "int8", mixed_trace(
                8, PROMPT_LENS, (16, 32), cfg.vocab, seed=SEED),
                dataclasses.replace(cfg, n_layers=n_cut),
                _first_layers(params, n_cut)))
        for step, pool, trace, cfg_run, params_run in runs:
            rt_run = dataclasses.replace(rt, cache_dtype=pool)
            sv = _sv(step=step)
            out = {}
            for mode in ("graphs", "eager"):
                label = (f"{arch}, {step}, {cfg_run.n_layers} layers, {pool} "
                         f"pool, {mode}")
                engine, n, stats, tokens = serve_engine(
                    torch, cfg_run, params_run, rt_run, sv, trace,
                    PROMPT_LENS, label, eager=mode == "eager")
                forwards = _dense_launches(label, n, step, cfg_run.n_layers,
                                           per_layer)
                if mode == "graphs" and more and step == "bucketed":
                    prof = profile_steps(torch, engine, cfg.vocab, "dense")
                    att = engine.profile()
                    say(f"serve ({label}): {forwards} forwards; decode step "
                        f"{prof['ms']:.3f} ms ({prof.get('replay_ms', 0):.3f}"
                        f" ms a replay); engine.profile(): decode step "
                        f"{att['decode_step_us']} us, decode attention "
                        f"{att['attn_us']} us ({cfg.n_layers} x one call), "
                        f"attn_frac {att['attn_frac']}")
                del engine
                out[mode] = (n, tokens)
            (n, tokens), (n_e, eager) = out["graphs"], out["eager"]
            if eager != tokens or n_e != n:
                diff = [r for r in eager if tokens.get(r) != eager[r]]
                fail(f"serve ({arch}, {step}): captured vs eager: requests "
                     f"{diff} differ in tokens, launches {json.dumps(n)} vs "
                     f"{json.dumps(n_e)}")
            launches.append(n)
            say(f"serve ({arch}, {step}): every request's tokens and the "
                "kernel launches equal the eager run's")
        del params, runs
        torch.cuda.empty_cache()
        say(f"dense: {arch} in {time.perf_counter() - t0:.1f} s")
    return {k: sum(n[k] for n in launches) for k in launches[0]}


#: the training phase (train_runs): full-width qwen2-0.5b, W4A4 QAT
#: through the fake_quant straight-through estimator on the synthetic
#: data, 6 steps of 8 sequences of 128 tokens, checkpoints every 3 steps
TRAIN = dict(batch=8, seq=128, steps=6, save_every=3)
#: the depth at which step 1 is held to the CPU (full width, float32
#: activations, fake_quant), and the bounds: both devices quantize the same
#: float32 activations to int4 per row, and a value that lands on the other
#: side of a rounding boundary (float32 sums in another order) moves its
#: row by a quantization step, so the loss (an average over every token)
#: is held to relative 1e-4 and the gradient's global norm to 1e-3
TRAIN_CPU_LAYERS = 2
TRAIN_CPU_BATCH = 2
TRAIN_CPU_LOSS_RTOL = 1e-4
TRAIN_CPU_GNORM_RTOL = 1e-3


def _qwen2_params(cfg) -> int:
    """The parameter count of a qwen2-family config (tied embeddings, qkv
    biases, SwiGLU)."""
    D, hd = cfg.d_model, cfg.hd
    qo, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = 2 * D * qo + 2 * D * kv + qo + 2 * kv + 3 * D * cfg.d_ff + 2 * D
    return cfg.vocab_padded * D + D + cfg.n_layers * layer


def _train_state_equal(a, b) -> list:
    """The paths of the leaves of two train states that differ in bits."""
    from repro_torch.checkpoint.ckpt import _flatten

    fa, fb = _flatten(a), _flatten(b)
    if sorted(fa) != sorted(fb):
        return ["<tree structure>"]
    return [k for k in fa if fa[k].dtype != fb[k].dtype
            or not bool((fa[k] == fb[k]).all())]


def _train_vs_cpu(torch, cfg) -> None:
    """One train step of `cfg` at TRAIN_CPU_LAYERS layers (full width), in
    float32 under fake_quant, on the card and on the CPU from the same
    weights and batch: loss and grad norm within the TRAIN_CPU bounds."""
    from repro_torch.configs import Runtime
    from repro_torch.convert import tree_to
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import init_train_state, make_train_step

    cut = dataclasses.replace(cfg, n_layers=TRAIN_CPU_LAYERS)
    rt = Runtime(attn_impl="chunked", attn_chunk_q=TRAIN["seq"],
                 loss_chunk=0, quant_backend="fake_quant",
                 compute_dtype="float32")
    state = init_train_state(
        torch.Generator(device="cuda").manual_seed(SEED), cut)
    tokens = torch.from_numpy(SyntheticLMDataset(
        vocab=cut.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN_CPU_BATCH,
        seed=SEED).batch(0))
    step = make_train_step(cut, rt, total_steps=TRAIN["steps"])
    t0 = time.perf_counter()
    _, card = step(state, tokens.cuda())
    card = {k: float(v) for k, v in card.items()}
    _, cpu = step(tree_to(state, "cpu"), tokens)
    cpu = {k: float(v) for k, v in cpu.items()}
    d_loss = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    d_gn = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    say(f"train: step 1 at {cut.n_layers} layers, full width, float32, "
        f"fake_quant, {TRAIN_CPU_BATCH} x {TRAIN['seq']} tokens: loss card "
        f"{card['loss']!r} cpu {cpu['loss']!r} (relative {d_loss:.3e}, "
        f"bound {TRAIN_CPU_LOSS_RTOL}); grad norm card "
        f"{card['grad_norm']!r} cpu {cpu['grad_norm']!r} (relative "
        f"{d_gn:.3e}, bound {TRAIN_CPU_GNORM_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(map(math.isfinite, (*card.values(), *cpu.values()))) or \
            d_loss > TRAIN_CPU_LOSS_RTOL or d_gn > TRAIN_CPU_GNORM_RTOL:
        fail(f"train: step 1 on the card {card} against the CPU {cpu}")


class _timed_ckpt:
    """Within the block, the wall time of every train checkpoint save and
    restore (``checkpoint.ckpt``'s, as `CheckpointManager` calls them),
    by kind."""

    def __enter__(self):
        from repro_torch.checkpoint import ckpt

        self.ckpt, self.orig = ckpt, (ckpt.save_checkpoint,
                                      ckpt.restore_checkpoint)
        self.times = {"save": [], "restore": []}

        def timed(kind, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.times[kind].append(time.perf_counter() - t0)
                return out
            return run
        ckpt.save_checkpoint = timed("save", self.orig[0])
        ckpt.restore_checkpoint = timed("restore", self.orig[1])
        return self.times

    def __exit__(self, *exc):
        self.ckpt.save_checkpoint, self.ckpt.restore_checkpoint = self.orig
        return False


def _remat_steps(torch, cfg, state) -> None:
    """The train step's wall time from `state` under each remat (the
    trainer's runtime otherwise): 3 steps each, the median of the last 2
    printed.  The steps' results are dropped."""
    from repro_torch.configs import Runtime
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step

    tokens = torch.from_numpy(SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
        seed=SEED).batch(0)).cuda()
    out = {}
    base = torch.cuda.memory_allocated()    # the trained state included
    for remat in ("none", "full", "dots"):
        rt = Runtime(attn_impl="chunked", attn_chunk_q=TRAIN["seq"],
                     loss_chunk=0, quant_backend="fake_quant", remat=remat)
        step = make_train_step(cfg, rt, total_steps=TRAIN["steps"])
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            _, m = step(state, tokens)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        out[remat] = (sorted(times[1:])[0] * 1e3,
                      (torch.cuda.max_memory_allocated() - base) / 2**30)
    say("train: step ms and peak GiB over the state's by remat (3 steps "
        "each, the faster of the last 2): "
        + ", ".join(f"{k} {ms:.1f} ms {gib:.2f} GiB"
                    for k, (ms, gib) in out.items()))
    # one step of the trainer's runtime (remat "dots") under the profiler:
    # the card's busy share and where its time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, tokens)
        float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    kernels = sorted((e for e in events if dev_us(e) > 0
                      and str(e.device_type).endswith("CUDA")), key=dev_us,
                     reverse=True)
    busy = sum(dev_us(e) for e in kernels)
    say(f"profile (train step, dots): {wall_us / 1e3:.1f} ms with the "
        f"profiler, {sum(e.count for e in kernels)} device kernels, device "
        + (f"busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall time"
           if busy else "time not measured (the profiler saw none)"))
    for e in kernels[:8]:
        say(f"profile (train step):   {dev_us(e) / 1e3:8.3f} ms {e.count:5d}x"
            f"  {e.key[:90]}")
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:6]:
        say(f"profile (train step, host):   {e.self_cpu_time_total / 1e3:8.3f}"
            f" ms {e.count:5d}x  {e.key[:90]}")


def train_runs(torch):
    """Full-width qwen2-0.5b trained and served from its own quantized
    checkpoint.  (1) Step 1 against the CPU (`_train_vs_cpu`).  (2) Under
    ``torch.use_deterministic_algorithms``: `launch.train.train` for
    TRAIN's 6 steps of W4A4 QAT (fake_quant) on the synthetic data with no
    checkpoint: every loss and grad norm finite; the step's wall time after
    the first, tokens/s trained and the card's peak memory printed.  (3)
    The same run preempted: 3 steps saved at step 3, then a new `train()`
    resuming from that checkpoint to step 6 (saved at 6): its final state
    (params, moments, steps) bit-equal to the straight run's and its
    losses equal.  The two train checkpoints live in a temporary directory
    removed after; the free disk is printed first, and the trained depth
    cut if it is short.  (4) The trained masters packed under serve_w4a4
    into a quantized checkpoint, restored with the plan checked and saved
    as float masters beside it (`launch.serve.quantized_ckpt_report`):
    the restored tree's logits bit-equal to the in-memory pack; then the
    Poisson trace served from the restored tree on the paged layout,
    bucketed, bf16 pool, captured: 8 of 8 ok, the W4A4 GEMM 7 times a
    layer a forward, flash prefill and paged decode once a layer a
    prefill or step.  Returns that run's launches."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.launch.serve import quantized_ckpt_report
    from repro_torch.launch.train import train
    from repro_torch.serving.api import poisson_trace

    t_phase = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    _train_vs_cpu(torch, cfg)

    root = tempfile.mkdtemp(prefix="train_runs_")
    try:
        free = shutil.disk_usage(root).free
        layers = LAYERS
        # two train states (params, mu, nu in f32) on disk at once
        while layers > 1 and 2 * 12 * _qwen2_params(dataclasses.replace(
                cfg, n_layers=layers)) * 1.1 > free:
            layers -= 1
        cut = dataclasses.replace(cfg, n_layers=layers)
        n_params = _qwen2_params(cut)
        say(f"train: {free / 2**30:.1f} GiB free under {root}; "
            f"{cut.n_layers} of {LAYERS} layers trained ({n_params:,} "
            f"parameters, a train checkpoint ~{12 * n_params / 2**30:.2f} "
            "GiB)" + ("" if layers == LAYERS else " -- DEPTH CUT FOR DISK"))
        kw = dict(cfg=cut, batch=TRAIN["batch"], seq=TRAIN["seq"],
                  save_every=TRAIN["save_every"], quant_backend="fake_quant",
                  seed=SEED, device="cuda")
        torch.use_deterministic_algorithms(True)
        try:
            steps = []

            def on_step(step, m, dt):
                steps.append((m, dt))
                if not all(map(math.isfinite, m.values())):
                    fail(f"train: step {step + 1} not finite: {m}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()   # earlier phases' leftovers
            t0 = time.perf_counter()
            straight, losses = train(cut.name, steps=TRAIN["steps"],
                                     ckpt_dir=None, on_step=on_step, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            later = [dt for _, dt in steps[1:]]
            step_ms = sorted(later)[len(later) // 2] * 1e3
            tokens = TRAIN["batch"] * TRAIN["seq"]
            say(f"train: {len(steps)} QAT steps (fake_quant W4A4) of "
                f"{TRAIN['batch']} x {TRAIN['seq']} tokens at full width, "
                f"{cut.n_layers} layers, deterministic algorithms, in "
                f"{time.perf_counter() - t0:.1f} s: step 1 "
                f"{steps[0][1] * 1e3:.1f} ms, later steps median "
                f"{step_ms:.1f} ms ({[round(d * 1e3, 1) for d in later]}), "
                f"{tokens / (step_ms / 1e3):.0f} tokens/s trained; peak "
                f"memory {peak / 2**30:.2f} GiB over the "
                f"{base / 2**30:.2f} GiB allocated before the run")
            say("train: losses " + json.dumps(losses) + "; grad norms "
                + json.dumps([m["grad_norm"] for m, _ in steps])
                + "; rates " + json.dumps([m["lr"] for m, _ in steps]))
            _remat_steps(torch, cut, straight)
            d = os.path.join(root, "run")
            with _timed_ckpt() as io_s:
                t0 = time.perf_counter()
                _, first = train(cut.name, steps=TRAIN["save_every"],
                                 ckpt_dir=d, **kw)
                t1 = time.perf_counter()
                resumed, second = train(cut.name, steps=TRAIN["steps"],
                                        ckpt_dir=d, **kw)
                t2 = time.perf_counter()
        finally:
            torch.use_deterministic_algorithms(False)
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
        say(f"train: preempted run: 3 steps and a save in {t1 - t0:.1f} s, "
            f"then a new train() resumed from step 3 (restore, 3 steps, a "
            f"save) in {t2 - t1:.1f} s; two train checkpoints "
            f"{ckpt_bytes / 2**30:.2f} GiB on disk; saves "
            f"{[round(t, 3) for t in io_s['save']]} s, restore "
            f"{[round(t, 3) for t in io_s['restore']]} s")
        diff = _train_state_equal(straight, resumed)
        if diff or first + second != losses:
            fail(f"train: the resumed run's state differs from the straight "
                 f"run's in {diff[:8]} (losses {first + second} vs "
                 f"{losses})")
        say("train: the resumed run's params, moments and steps equal the "
            "straight run's bit for bit, and its losses")
        del straight
        shutil.rmtree(d)

        masters = resumed["params"]
        del resumed
        torch.cuda.empty_cache()
        rt = Runtime(attn_impl="flash", quant_plan="serve_w4a4")
        restored, reference, rep = quantized_ckpt_report(
            cut, rt, os.path.join(root, "serve"), masters, seed=SEED)
        del masters, reference
        say("train: quantized checkpoint (serve_w4a4) of the trained "
            f"masters: {rep['quantized_bytes']:,} bytes against "
            f"{rep['float_master_bytes']:,} of float masters; save "
            f"{rep['save_s']:.3f} s, load {rep['load_s']:.3f} s (float "
            f"save {rep['float_save_s']:.3f} s); logits bit-identical to "
            f"the in-memory pack: {rep['bit_identical_logits']}")
        if not rep["bit_identical_logits"]:
            fail("train: the restored quantized checkpoint's logits differ "
                 "from the plan packed from the same masters in memory")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    trace = poisson_trace(8, 0.5, PROMPT_LENS, GEN_LENS, cut.vocab,
                          seed=SEED)
    label = "trained, from the quantized checkpoint"
    engine, n, _, _ = serve_engine(torch, cut, restored, rt, _sv(), trace,
                                   PROMPT_LENS, label)
    forwards = _dense_launches(label, n, "bucketed", cut.n_layers,
                               gemms_a_block("A", cut))
    say(f"serve ({label}): {forwards} forwards, the GEMM 7 times a layer "
        f"each; the phase in {time.perf_counter() - t_phase:.1f} s")
    del engine, restored
    torch.cuda.empty_cache()
    return n


#: the projections a rank of a tensor-parallel mesh cuts (name, K, N, how):
#: column-parallel shards N, row-parallel K (``distributed.tensor_parallel``)
def _tp_projections(cfg):
    D, F, q, kv = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd, \
        cfg.n_kv_heads * cfg.hd
    return (("wq", D, q, "col"), ("wk/wv", D, kv, "col"),
            ("w_in/w_gate", D, F, "col"), ("wo", q, D, "row"),
            ("w_out", F, D, "row"))


DIST_ARCHS = ("qwen2-0.5b", "qwen3-4b")
DIST_TPS = (2, 4)
DIST_ROWS = (8, PROMPT_BUCKET)
#: the train runs of the (1, 1) mesh check
DIST_TRAIN = dict(batch=8, seq=128, steps=2)


class _ThreadRanks:
    """The ``model`` axis's two collectives between `n` threads, one a
    rank, on the one card: each rank's tensor is put in its slot, and
    every rank reads the reduction of all slots (ranks in order)."""

    def __init__(self, n):
        import threading

        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def reduce(self, rank, t, op):
        self.slots[rank] = t
        self.barrier.wait()
        out = self.slots[0]
        for other in self.slots[1:]:
            out = op(out, other)
        self.barrier.wait()
        return out

    def run(self, body):
        """[body(rank, reduce_max, reduce_sum) for every rank], each rank
        in its own thread."""
        import threading

        import torch

        outs, errs = [None] * self.n, []

        def one(r):
            try:
                outs[r] = body(
                    r, lambda t: self.reduce(r, t, torch.maximum),
                    lambda t: self.reduce(r, t, torch.add))
            except BaseException as e:          # re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return outs


def _tp_shard_checks(torch, timer):
    """Each rank's local W4A4 GEMM of qwen2-0.5b's and qwen3-4b's
    projections at tp 2 and 4 on the one card, held bit for bit to the
    whole projection's fused kernel call: column shards through the fused
    kernel, concatenated; row shards through the shipped
    ``w4a4_row_parallel``, one thread a rank, its ``RowComm``'s max and sum
    between the threads (`_ThreadRanks`).  Prints each shard shape's
    `w4a4_plan`, and its time at M = 8 and 256 beside the whole's: the
    column shard's fused call, the row shard's whole body (amax, quantize,
    integer partials, epilogue; no collective) with its collectives the
    identity."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import pack_int4, quant_scale, quantize
    from repro_torch.distributed.tensor_parallel import (RowComm,
                                                         w4a4_row_parallel)
    from repro_torch.kernels import ops
    from repro_torch.kernels.int4_matmul import w4a4_plan
    from repro_torch.kernels.packing import nmajor_to_kmajor_grouped

    def ident(t):
        return t

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    n_checked = 0
    for arch in DIST_ARCHS:
        cfg = get_config(arch)
        for name, K, N, how in _tp_projections(cfg):
            w = torch.randn((K, N), generator=gen, device="cuda")
            w_scale = quant_scale(w, axis=0, bits=4)
            packed = pack_int4(quantize(w, w_scale, bits=4), axis=-1)
            whole_km = nmajor_to_kmajor_grouped(packed, w_scale).contiguous()
            xs = {M: torch.randn((M, K), generator=gen, device="cuda") * 3
                  for M in DIST_ROWS}
            whole = {M: ops.int4_matmul_fused_kmajor(x, whole_km, w_scale)
                     for M, x in xs.items()}
            whole_ms = {M: timer.ms(lambda x=x: ops.int4_matmul_fused_kmajor(
                x, whole_km, w_scale)) for M, x in xs.items()}
            for tp in DIST_TPS:
                if how == "col":
                    n = N // tp
                    shards = [(packed[:, r * n // 2:(r + 1) * n // 2],
                               w_scale[:, r * n:(r + 1) * n])
                              for r in range(tp)]
                else:
                    k = K // tp
                    shards = [(packed[r * k:(r + 1) * k], w_scale)
                              for r in range(tp)]
                kms = [nmajor_to_kmajor_grouped(p, sc).contiguous()
                       for p, sc in shards]
                ws = [{"packed": p, "scale": sc, "packed_km": km}
                      for (p, sc), km in zip(shards, kms)]
                Kl, Nl = (K, N // tp) if how == "col" else (K // tp, N)
                plans, times = [], []
                for M, x in xs.items():
                    try:
                        plan = w4a4_plan(M, Kl, Nl, kms[0].shape[0])
                    except ValueError as e:
                        fail(f"dist: {arch} {name} tp {tp}: the plan refuses "
                             f"the shard shape ({M}, {Kl}, {Nl}): {e}")
                    plans.append(f"M={M}: {plan}")
                    if how == "col":
                        got = torch.cat([ops.int4_matmul_fused_kmajor(
                            x, km, sc) for km, (_, sc) in zip(kms, shards)],
                            dim=1)
                        ms = timer.ms(lambda x=x: ops.int4_matmul_fused_kmajor(
                            x, kms[0], shards[0][1]))
                    else:
                        parts = [x[:, r * Kl:(r + 1) * Kl].contiguous()
                                 for r in range(tp)]
                        # timed first, in this thread: the kernels are
                        # loaded before the rank threads call them
                        ms = timer.ms(lambda: w4a4_row_parallel(
                            parts[0], ws[0],
                            comm=RowComm(ident, ident, 0, tp)))
                        outs = _ThreadRanks(tp).run(
                            lambda r, mx, sm: w4a4_row_parallel(
                                parts[r], ws[r],
                                comm=RowComm(mx, sm, r, tp)))
                        got = outs[0]
                        if not all(torch.equal(o, got) for o in outs[1:]):
                            fail(f"dist: {arch} {name} tp {tp} at M = {M}: "
                                 "the ranks' outputs differ")
                    if not torch.equal(got, whole[M]):
                        bad = (got != whole[M]).sum().item()
                        fail(f"dist: {arch} {name} tp {tp} ({how}) at M = "
                             f"{M}: {bad} outputs differ from the whole "
                             "projection's kernel call")
                    times.append(f"M={M}: shard {ms:.4f} ms, whole "
                                 f"{whole_ms[M]:.4f} ms")
                    n_checked += 1
                say(f"dist: {arch} {name} ({how}-parallel) tp {tp}: shard "
                    f"({Kl}, {Nl}) of ({K}, {N}), {tp} shards bit-equal to "
                    f"the whole; {'; '.join(plans)}; {'; '.join(times)}")
    launches = {}
    for arch in DIST_ARCHS:
        n, got = _row_backend_shards(torch, timer, gen, get_config(arch))
        n_checked += n
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    return n_checked, launches


#: the row-parallel bodies of the backends that quantize a float master per
#: call or are weight-only (``tensor_parallel.master_rows``,
#: ``packed_rows``): (backend, group size, packed)
ROW_BACKENDS = (("int_sim", 0, False), ("lut4", 0, False),
                ("w4a16", 128, False), ("w4a16", 0, False),
                ("w4a16_packed", 0, True), ("w4a16_packed", 128, True))
#: the integer ones are bit-equal to the whole call; W4A16 sums f32
#: partials in another order
ROW_EXACT = ("int_sim", "lut4")


def _row_backend_shards(torch, timer, gen, cfg):
    """`cfg`'s row-parallel projections (``wo``, ``ffn/w_out``) under each
    of ROW_BACKENDS at tp 2 and 4 and M = 8 and 256: every rank's shipped
    body (global scales max-reduced, the plan's kernel on the local rows,
    the partials summed) in a thread of its own (`_ThreadRanks`), the sum
    held to the whole projection's single-device call (``qdense``): bit
    for bit for the integer GEMMs, within W4A16_RTOL for W4A16.  A packed
    grouped weight whose groups the rules cannot cut whole at a tp (K / G
    not divisible) is skipped, as ``place`` refuses it.  Prints each
    shard's body time beside the whole call's.  Returns (checks, the
    kernel launches of the rank runs)."""
    from repro_torch.core.qlinear import (QuantConfig, pack_weight_nd,
                                          prepack_tree, qdense)
    from repro_torch.distributed.tensor_parallel import (RowComm,
                                                         master_rows,
                                                         packed_rows)
    from repro_torch.kernels import ops

    def ident(t):
        return t

    n_checked, launches = 0, {}
    rows = [p for p in _tp_projections(cfg) if p[3] == "row"]
    for name, K, N, _ in rows:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
        xs = {M: torch.randn((M, K), generator=gen, device="cuda") * 3
              for M in DIST_ROWS}
        for backend, G, packed in ROW_BACKENDS:
            qc = QuantConfig(backend=backend, group_size=G)
            label = f"{backend}{'/g' + str(G) if G else ''}"
            whole_w = (prepack_tree({"w": pack_weight_nd(w, qc)})["w"]
                       if packed else w)
            whole = {M: qdense(whole_w, x, qc) for M, x in xs.items()}
            sc = whole_w["scale"] if packed else None
            groups = sc.shape[0] if packed and sc.dim() == 3 else 0
            for tp in DIST_TPS:
                k = K // tp
                if groups % tp:
                    say(f"dist rows: {cfg.name} {name} {label} tp {tp}: "
                        f"skipped ({groups} groups of {G} do not cut whole "
                        "over the ranks; place() refuses the weight)")
                    continue
                if packed:
                    g = groups // tp
                    shards = [prepack_tree({"w": {
                        "packed": whole_w["packed"][r * k:(r + 1) * k],
                        "scale": sc[r * g:(r + 1) * g] if groups else sc}}
                    )["w"] for r in range(tp)]
                    body = packed_rows
                else:
                    shards = [w[r * k:(r + 1) * k] for r in range(tp)]
                    body = master_rows
                times = []
                for M, x in xs.items():
                    parts = [x[:, r * k:(r + 1) * k].contiguous()
                             for r in range(tp)]
                    # timed first, in this thread (the kernels loaded)
                    ms = timer.ms(lambda: body(
                        shards[0], parts[0], qc,
                        comm=RowComm(ident, ident, 0, tp)))
                    whole_ms = timer.ms(lambda x=x: qdense(whole_w, x, qc))
                    ops.reset_launch_counts()
                    outs = _ThreadRanks(tp).run(
                        lambda r, mx, sm: body(shards[r], parts[r], qc,
                                               comm=RowComm(mx, sm, r, tp)))
                    torch.cuda.synchronize()
                    for kname, n in ops.launch_counts().items():
                        launches[kname] = launches.get(kname, 0) + n
                    got = outs[0]
                    if not all(torch.equal(o, got) for o in outs[1:]):
                        fail(f"dist rows: {cfg.name} {name} {label} tp {tp} "
                             f"at M = {M}: the ranks' outputs differ")
                    ref = whole[M]
                    if backend in ROW_EXACT:
                        if not torch.equal(got, ref):
                            bad = (got != ref).sum().item()
                            fail(f"dist rows: {cfg.name} {name} {label} tp "
                                 f"{tp} at M = {M}: {bad} outputs differ "
                                 "from the whole call")
                        err = 0.0
                    else:
                        err = (got - ref).abs().max().item()
                        lim = W4A16_RTOL * ref.abs().max().item()
                        if err > lim:
                            fail(f"dist rows: {cfg.name} {name} {label} tp "
                                 f"{tp} at M = {M}: max |diff| {err:.3g} > "
                                 f"{lim:.3g}")
                    times.append(f"M={M}: shard {ms:.4f} ms, whole "
                                 f"{whole_ms:.4f} ms, max |diff| {err:.3g}")
                    n_checked += 1
                say(f"dist rows: {cfg.name} {name} ({K}, {N}) {label} tp "
                    f"{tp}: shard ({k}, {N}), the sum of {tp} ranks "
                    f"{'bit-equal to' if backend in ROW_EXACT else 'within W4A16_RTOL of'}"
                    f" the whole call; {'; '.join(times)}")
    return n_checked, launches


def dist_runs(torch):
    """The distribution layer on the one card.  (1) NCCL at world 1 (a
    ``file://`` store), its version printed and an all-reduce run.  (2)
    Full-width qwen2-0.5b (24 layers, fake_quant W4A4, remat "none",
    deterministic algorithms): DIST_TRAIN's steps of
    ``train(mesh_spec="1,1")`` against ``train()``: losses and final
    parameters bit-equal.  (3) W4A4-packed prefill and three decode steps
    (contiguous cache, flash prefill) of full-width qwen2-0.5b under a
    (1, 1) mesh against the unsharded steps: logits bit-equal, the fused
    GEMM and flash prefill launched (counts zeroed just before the mesh
    run).  (4) `_tp_shard_checks`.  Returns the mesh run's launches."""
    import torch.distributed as dist

    from repro_torch.configs import Runtime, get_config
    from repro_torch.distributed.sharding import mesh_context, place
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, single_device_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import init_caches
    from repro_torch.serving.engine import build_params

    t0 = time.perf_counter()
    init_distributed("cuda")
    one = torch.ones(4, device="cuda")
    dist.all_reduce(one)
    torch.cuda.synchronize()
    say(f"dist: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
        f"backend {dist.get_backend()}, world {dist.get_world_size()} "
        f"(file:// store); all_reduce at world 1: {one.tolist()}")
    try:
        cfg = get_config("qwen2-0.5b")
        kw = dict(cfg=cfg, ckpt_dir=None, quant_backend="fake_quant",
                  seed=SEED, device="cuda", remat="none", **DIST_TRAIN)
        torch.use_deterministic_algorithms(True)
        try:
            t1 = time.perf_counter()
            plain, l_plain = train(cfg.name, **kw)
            t2 = time.perf_counter()
            meshed, l_mesh = train(cfg.name, mesh_spec="1,1", **kw)
            t3 = time.perf_counter()
        finally:
            torch.use_deterministic_algorithms(False)
        diff = _train_state_equal(plain, meshed)
        if diff or l_plain != l_mesh:
            fail(f"dist: train(mesh_spec='1,1') differs from train() in "
                 f"{diff[:8]} (losses {l_mesh} vs {l_plain})")
        say(f"dist: {DIST_TRAIN['steps']} QAT steps of full-width "
            f"{cfg.name} ({cfg.n_layers} layers, {DIST_TRAIN['batch']} x "
            f"{DIST_TRAIN['seq']}) under a (1, 1) NCCL mesh in "
            f"{t3 - t2:.1f} s against {t2 - t1:.1f} s unsharded: losses "
            f"{l_mesh} and final params, moments and steps bit-equal")
        del plain, meshed
        torch.cuda.empty_cache()

        rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
        params = build_params(cfg, rt, seed=SEED, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(SEED + 41)
        toks = torch.randint(0, cfg.vocab, (2, 64), generator=g,
                             device="cuda", dtype=torch.int32)

        def steps(p):
            pre, dec = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
            logits, caches = pre(p, toks, init_caches(cfg, rt, 2, 128))
            out = [logits]
            for i in range(3):
                tok = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
                pos = torch.full((2, 1), toks.shape[1] + i,
                                 dtype=torch.int32, device="cuda")
                logits, caches = dec(p, tok[:, None], caches, pos)
                out.append(logits)
            return out

        ref = steps(params)
        mesh = single_device_mesh("cuda")
        with mesh_context(mesh):
            local, _ = place(params, mesh)
            ops.reset_launch_counts()
            got = steps(local)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        bad = [i for i, (a, b) in enumerate(zip(got, ref))
               if not torch.equal(a, b)]
        if bad:
            fail(f"dist: W4A4 steps {bad} under a (1, 1) mesh differ from "
                 "the unsharded steps")
        if not (launches["int4_matmul_fused"] and launches["flash_prefill"]):
            fail(f"dist: the (1, 1) mesh's steps did not launch the fused "
                 f"GEMM and flash prefill: {json.dumps(launches)}")
        say(f"dist: W4A4-packed prefill (2 x 64) and 3 decode steps of "
            f"full-width {cfg.name} under a (1, 1) mesh: logits bit-equal "
            f"to the unsharded steps; launches {json.dumps(launches)}")
        del params, local, ref, got
        torch.cuda.empty_cache()
        timer = Timer(torch)
        t4 = time.perf_counter()
        n, shard_launches = _tp_shard_checks(torch, timer)
        launches = {k: launches[k] + shard_launches.get(k, 0)
                    for k in launches}
        say(f"dist: {n} shard combinations held to the whole call in "
            f"{time.perf_counter() - t4:.1f} s (the row-parallel rank "
            f"runs' launches {json.dumps(shard_launches)}); the phase in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return launches


#: the dry-run's cells run on the chip machine's host (fake process groups,
#: fake CPU tensors; nothing reaches the card): (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k", False),
                ("qwen3-4b", "train_4k", False),
                ("arctic-480b", "prefill_32k", False),
                ("qwen2-0.5b", "train_4k", True))
#: the calibration steps (full-width qwen2-0.5b at a (1, 1) mesh), each
#: run on the card and dry-run: name -> (step kind, batch, sequence).  The
#: eager W4A4 steps and the QAT step wait on the host's dispatch; the float
#: prefill of 8 x 1024 keeps the card busy (bf16 GEMMs at M = 8192, flash
#: prefill), so that its time comes near the bound and the gate can fail.
CALIBRATION = {"decode": ("decode", 8, 512), "prefill": ("prefill", 2, 64),
               "prefill_float": ("prefill", 8, 1024),
               "train": ("train", 8, 128)}
#: timed repetitions of each calibration step: 10 until the analysis and
#: tuning phase came (its ~9 s paid for by the train step's five, ~1 s each)
CALIBRATION_REPS = 5
#: the pipeline check's microbatches (one stage; a full-width block)
PIPE_MICRO = (1, 4)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _event_ms(torch, fn, reps: int, warmup: int = 2):
    """Median ms of `fn()` over `reps` calls (CUDA events, after `warmup`
    calls), and the peak memory allocated during them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2], torch.cuda.max_memory_allocated()


def _calibration_real(torch, cfg, rts, shapes):
    """The calibration steps on the card at a (1, 1) NCCL mesh: for each,
    its arguments' bytes, median ms and peak memory; and the kernel
    launches of the serving steps' calls.  One serving parameter tree at a
    time: the W4A4-packed one for the decode and its prefill, then the
    float one."""
    from repro_torch.distributed.sharding import mesh_context, place
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.steps import (init_train_state, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          train_shardings)
    from repro_torch.models.transformer import init_caches
    from repro_torch.optim import adamw_init
    from repro_torch.serving.engine import build_params

    mesh = single_device_mesh("cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    out, launches = {}, {}
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    with mesh_context(mesh):
        params, backend = None, None
        for name in ("decode", "prefill", "prefill_float"):
            shape, rt = shapes[name], rts[name]
            kind, B, S = shape.kind, shape.batch, shape.seq
            if rt.quant_backend != backend:
                params, backend = None, rt.quant_backend
                torch.cuda.empty_cache()
                params, _ = place(build_params(cfg, rt, seed=SEED,
                                               device="cuda"), mesh)
            caches = init_caches(cfg, rt, B, S, device="cuda")
            if kind == "decode":
                tok = torch.randint(0, cfg.vocab, (B, 1), generator=g,
                                    device="cuda", dtype=torch.int32)
                pos = torch.full((B, 1), S // 2, dtype=torch.int32,
                                 device="cuda")
                step = make_decode_step(cfg, rt)
                args = (params, tok, caches, pos)
            else:
                tok = torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    device="cuda", dtype=torch.int32)
                step = make_prefill_step(cfg, rt)
                args = (params, tok, caches)
            ops.reset_launch_counts()
            ms, peak = _event_ms(torch, lambda: step(*args),
                                 CALIBRATION_REPS)
            for k, n in ops.launch_counts().items():
                launches[k] = launches.get(k, 0) + n
            out[name] = {"bytes": _nbytes(args), "ms": ms,
                         "peak": peak - mem0}
            del caches, args
        del params
        torch.cuda.empty_cache()
        shape, rt = shapes["train"], rts["train"]
        state = init_train_state(torch.Generator(device="cuda").manual_seed(
            SEED), cfg)
        p, psh = place(state["params"], mesh)
        state = {"params": p, "opt": adamw_init(p), "step": state["step"]}
        batch = torch.randint(0, cfg.vocab, (shape.batch, shape.seq + 1),
                              generator=g, device="cuda", dtype=torch.int32)
        step = make_train_step(cfg, rt, shardings=train_shardings(psh, mesh))
        ms, peak = _event_ms(torch, lambda: step(state, batch),
                             CALIBRATION_REPS)
        out["train"] = {"bytes": _nbytes((state, batch)), "ms": ms,
                        "peak": peak - mem0}
        del state, batch, p, psh
    torch.cuda.empty_cache()
    return out, launches


def _pipeline_on_card(torch):
    """``pipeline_apply``'s forward and backward at a one-stage NCCL mesh
    with a full-width qwen2-0.5b block (bf16 activations, f32 weights) as
    the stage function, held bit for bit to the block applied to each
    microbatch and differentiated microbatch by microbatch, last first
    (the schedule's order of summing a stage's gradients): the loss, the
    gradients of the input and of every parameter."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _like
    from repro_torch.models.transformer import apply_block, init_block
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_config("qwen2-0.5b")
    rt = Runtime(quant_backend="float", attn_impl="chunked", remat="none")
    stages = make_mesh((1,), ("stage",), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    block = init_block(gen, "A", cfg)
    stacked = tree_map(lambda t: t[None].contiguous(), block)
    mb, S = 2, 64

    def fn(p, xb):
        pos = torch.arange(S, dtype=torch.int32,
                           device="cuda").repeat(xb.shape[0], 1)
        return apply_block("A", p, xb, cfg, rt, pos)[0]

    torch.use_deterministic_algorithms(True)
    try:
        for n_micro in PIPE_MICRO:
            x = torch.randn((n_micro * mb, S, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            r = torch.randn(x.shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            stacked)
            xl = x.detach().requires_grad_(True)
            y = pipeline_apply(fn, live, xl, mesh=stages, n_micro=n_micro)
            loss = torch.sum(y.float() * r.float())
            got = torch.autograd.grad(loss, [xl, *tree_leaves(live)])
            # the reference: each microbatch through the block, the
            # gradients taken last microbatch first and summed in that
            # order
            leaves = [t.detach()[0].requires_grad_(True)
                      for t in tree_leaves(stacked)]
            p0 = _like(stacked, iter(leaves))
            xs = x.reshape(n_micro, mb, S, cfg.d_model)
            rs = r.reshape(xs.shape)
            ys, gx = [None] * n_micro, torch.zeros_like(xs)
            gp = [torch.zeros_like(t) for t in leaves]
            for i in reversed(range(n_micro)):
                xi = xs[i].detach().requires_grad_(True)
                ys[i] = fn(p0, xi)
                gy = torch.autograd.grad(
                    torch.sum(ys[i].float() * rs[i].float()), ys[i],
                    retain_graph=True)[0]
                gs = torch.autograd.grad(ys[i], [xi, *leaves], gy)
                gx[i] = gs[0]
                for acc, gi in zip(gp, gs[1:]):
                    acc += gi
            ref_loss = torch.sum(torch.cat([t.detach() for t in ys])
                                 .float() * r.float())
            bad = [] if torch.equal(loss.detach(), ref_loss) else ["loss"]
            if not torch.equal(got[0], gx.reshape(x.shape)):
                bad.append("x")
            bad += [i for i, (a, b) in enumerate(zip(got[1:], gp))
                    if not torch.equal(a[0], b)]
            if bad:
                fail(f"pipeline: at {n_micro} microbatches the pipelined "
                     f"block's loss or gradients {bad[:8]} differ from the "
                     "unpipelined block's")
            say(f"pipeline: full-width {cfg.name} block, one stage, "
                f"{n_micro} microbatches of {mb} x {S}: loss "
                f"{loss.item():.6f} and the gradients of x and all "
                f"{len(gp)} parameters bit-equal to the unpipelined "
                "block's")
    finally:
        torch.use_deterministic_algorithms(False)


#: the calibration steps' dry-runs, in a process of their own on a fake
#: process group of one rank: the counts of each kind's cell as JSON
CALIBRATION_DRYRUN = r"""
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import Runtime, Shape, get_config
from repro_torch.distributed.sharding import mesh_context
from repro_torch.launch.dryrun import (build_cell, cell_terms, count_step,
                                       memory_fields)
from repro_torch.launch.mesh import init_fake, make_mesh

cells = json.loads(sys.argv[1])
init_fake(1)
mesh = make_mesh((1, 1), ("data", "model"), device="fake")
out = {}
for name, (kind, B, S, rt) in cells.items():
    with FakeTensorMode(), mesh_context(mesh):
        cell = build_cell(get_config("qwen2-0.5b"), Shape(name, kind, S, B),
                          Runtime(**rt), mesh)
        c = count_step(cell.fn, cell.args)
    out[name] = {"memory": memory_fields(cell, c), "parts": cell.parts,
                 "terms": cell_terms(c)}
print(json.dumps(out))
"""
#: the calibration steps' runtimes: the serving path's W4A4-packed weights
#: over an int4 contiguous cache, and the trainer's QAT step
CALIBRATION_RT = {
    "decode": dict(attn_impl="flash", quant_backend="w4a4_packed",
                   cache_dtype="int4"),
    "prefill": dict(attn_impl="flash", quant_backend="w4a4_packed",
                    cache_dtype="int4"),
    "prefill_float": dict(attn_impl="flash", quant_backend="float"),
    "train": dict(attn_impl="chunked", attn_chunk_q=128, loss_chunk=0,
                  quant_backend="fake_quant", remat="dots")}


class DryrunHost:
    """The dry-run's host work, started as subprocesses before `dist_runs`
    so that it overlaps the card's phases (no card: each process has
    ``CUDA_VISIBLE_DEVICES`` empty and counts on fake CPU tensors): one
    ``launch.dryrun`` CLI a DRYRUN_CELLS cell, on a fake group of 256 or
    512 ranks, and CALIBRATION_DRYRUN.  `stop` ends whichever still
    runs."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.out_dir = tempfile.mkdtemp(prefix="dryrun_")
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
        self.procs = {}
        for arch, shape, multi_pod in DRYRUN_CELLS:
            key = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--skip-probes",
                   "--out", self.out_dir] + (["--multi-pod"] if multi_pod
                                             else [])
            self.procs[key] = self._start(cmd, env)
        cells = {k: (kind, B, S, CALIBRATION_RT[k])
                 for k, (kind, B, S) in CALIBRATION.items()}
        self.procs["calibration"] = self._start(
            [sys.executable, "-c", CALIBRATION_DRYRUN, json.dumps(cells)],
            env)

    @staticmethod
    def _start(cmd, env):
        return subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def wait(self, key: str) -> str:
        """`key`'s standard output, once it has ended with exit code 0."""
        proc = self.procs[key]
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"dryrun: {key} exited {proc.returncode}: "
                 f"{stderr[-2000:]}")
        return stdout

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.out_dir, ignore_errors=True)


def dryrun_runs(torch, host: DryrunHost):
    """The dry-run (``launch.dryrun``), after `dist_runs`; its host work
    (`DryrunHost`) started before it.  (1) Calibration: CALIBRATION's four
    steps of full-width qwen2-0.5b (the W4A4-packed eager decode over an
    int4 contiguous cache, its prefill, a float prefill of 8 x 1024 that
    keeps the card busy, one QAT train step) at a (1, 1) mesh, each on the card (median of CALIBRATION_REPS CUDA-event timings
    after warm-up) and as a dry-run of the same cell on a fake group of one
    rank: the dry-run's argument bytes must equal the real tensors', and
    its ``step_s_lower_bound`` must not exceed the measured time; the peak
    memory estimate is printed beside ``torch.cuda.max_memory_allocated``
    over what was allocated before the step's arguments.  (2)
    `_pipeline_on_card`.  (3) DRYRUN_CELLS on the production meshes (16 x
    16; 2 x 16 x 16 for the multi-pod cell): each cell's status line
    printed, any status but ok a failure.  Returns the kernel launches of
    the real calibration steps."""
    import torch.distributed as dist

    from repro_torch.configs import Runtime, Shape, get_config
    from repro_torch.launch.mesh import init_distributed

    t0 = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    rts = {k: Runtime(**kw) for k, kw in CALIBRATION_RT.items()}
    shapes = {k: Shape(f"calibration_{k}", kind, S, B)
              for k, (kind, B, S) in CALIBRATION.items()}
    init_distributed("cuda")
    try:
        real, launches = _calibration_real(torch, cfg, rts, shapes)
        _pipeline_on_card(torch)
    finally:
        dist.destroy_process_group()
    dry = json.loads(host.wait("calibration").strip().splitlines()[-1])
    for kind in CALIBRATION:
        mem, terms, r = dry[kind]["memory"], dry[kind]["terms"], real[kind]
        bound = terms["step_s_lower_bound"] * 1e3
        _, B, S = CALIBRATION[kind]
        say(f"dryrun calibration ({kind}, {B} x {S}): argument bytes "
            f"{mem['argument_size_in_bytes']} dry-run, {r['bytes']} on the "
            f"card ({json.dumps(dry[kind]['parts'])}); measured "
            f"{r['ms']:.3f} ms (median of {CALIBRATION_REPS}) against the "
            f"bound {bound:.4f} ms ({terms['bound']}; compute "
            f"{terms['compute_s']:.3e}, memory {terms['memory_s']:.3e}, "
            f"collective {terms['collective_s']:.3e} s): measured/bound "
            f"{r['ms'] / bound:.1f}; peak estimate "
            f"{mem['total_hbm_bytes'] / 2**30:.3f} GiB against "
            f"max_memory_allocated {r['peak'] / 2**30:.3f} GiB over what "
            "was allocated before")
        if mem["argument_size_in_bytes"] != r["bytes"]:
            fail(f"dryrun calibration ({kind}): the dry-run's argument "
                 f"bytes {mem['argument_size_in_bytes']} are not the "
                 f"card's {r['bytes']}")
        if bound > r["ms"]:
            fail(f"dryrun calibration ({kind}): the card beat the dry-run's "
                 f"lower bound ({r['ms']:.4f} < {bound:.4f} ms): a wrong "
                 "count or constant")
    for key in host.procs:
        if key == "calibration":
            continue
        stdout = host.wait(key)
        lines = [ln for ln in stdout.splitlines() if key in ln]
        say(f"dryrun: {lines[0] if lines else key + ' (no status line)'}")
        path = os.path.join(host.out_dir, key + ".json")
        rep = json.load(open(path)) if os.path.exists(path) else {}
        if rep.get("status") != "ok":
            fail(f"dryrun: {key} status {rep.get('status')}: "
                 f"{rep.get('error', '')}")
        say(f"dryrun: {key} on {rep['devices']} fake ranks "
            f"{json.dumps(rep['mesh'])} in {rep['elapsed_s']} s: collectives "
            f"{json.dumps(rep['collectives']['count_by_kind'])}, cross-pod "
            f"bytes {rep['roofline']['cross_pod_bytes_per_dev']:.0f}")
    say(f"dryrun: the phase in {time.perf_counter() - t0:.1f} s, the host "
        f"work {time.perf_counter() - host.t0:.1f} s since it started")
    return launches


def phase_serve(torch):
    """The bucketed path (bf16 pool, Poisson trace), then the ragged path
    (int8 pool, mixed trace), on one set of full-width W4A4 weights; then
    the bucketed path on the Poisson trace under the W4A16 plan (pre-packed
    grouped weights) and under lut4 (on-the-fly weights, the same masters),
    both cut to RUN_LAYERS' depth, whose tokens must equal a W4A4 run's at
    the same depth.  On the W4A4 weights also
    `engine.profile()` after each of the first two runs, the shared-prefix
    runs (`prefix_runs`), the chaos runs (`chaos_runs`), the contiguous
    layout (`contiguous_runs`) and the compare harness (`compare_runs`);
    last, full-width mamba2-130m (`mamba_runs`), full-width
    recurrentgemma-9b (`hybrid_runs`), the paged configs (`dense_runs`)
    and training (`train_runs`).  Every part's time is printed.
    Returns the launches of all runs, summed."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.serving.api import mixed_trace, poisson_trace
    from repro_torch.serving.engine import build_params

    cfg = get_config("qwen2-0.5b")
    prompt_lens = PROMPT_LENS
    poisson = poisson_trace(8, 0.5, prompt_lens, GEN_LENS, cfg.vocab,
                            seed=SEED)
    launches, tokens = [], {}
    for runs, quant in ((("bucketed", "ragged"), "w4a4_packed"),
                        (("w4a16",), "w4a16"), (("lut4",), "lut4")):
        t0 = time.perf_counter()
        cut = dataclasses.replace(cfg, n_layers=RUN_LAYERS.get(runs[0],
                                                               LAYERS))
        params = build_params(cut, Runtime(**SERVE_RUNS[runs[0]][2]),
                              seed=SEED, device="cuda")
        torch.cuda.synchronize()
        say(f"serve: built full-width {cut.name} ({cut.n_layers} layers, "
            f"d_model {cut.d_model}, vocab {cut.vocab}) for {quant} in "
            f"{time.perf_counter() - t0:.1f} s")
        if quant == "lut4":
            # the W4A4 path on the same masters at the same depth: the
            # tokens the lut4 run must emit
            ref = build_params(cut, Runtime(quant_backend="w4a4_packed"),
                               seed=SEED, device="cuda")
            _, n, _, tokens["w4a4_at_depth"] = serve_engine(
                torch, cut, ref, Runtime(attn_impl="flash",
                                         quant_backend="w4a4_packed"),
                _sv(), poisson, prompt_lens,
                f"bucketed at {cut.n_layers} layers, graphs")
            launches.append(n)
            del ref
        for run in runs:
            t1 = time.perf_counter()
            trace = (mixed_trace(8, prompt_lens, (16, 32), cfg.vocab,
                                 seed=SEED) if run == "ragged" else poisson)
            run_params = (_first_layers(params, RUN_LAYERS[run])
                          if RUN_LAYERS.get(run, cut.n_layers)
                          < cut.n_layers else params)
            engine, n, _, tokens[run] = serve_run(torch, run_params, run,
                                                  trace, prompt_lens)
            launches.append(n)
            prof = {"graphs": profile_steps(torch, engine, cut.vocab, run)}
            if quant == "w4a4_packed":
                att = engine.profile()
                say(f"profile ({run}): engine.profile(): decode step "
                    f"{att['decode_step_us']} us, decode attention "
                    f"{att['attn_us']} us ({engine.cfg.n_layers} x one "
                    "call), "
                    f"attn_frac {att['attn_frac']}, at step "
                    f"{att['at_step']}; profile_steps' replay "
                    f"{prof['graphs']['replay_ms'] * 1e3:.1f} us of device "
                    "time")
            del engine
            engine, n_eager, _, eager = serve_run(torch, run_params, run,
                                                  trace, prompt_lens,
                                                  eager=True)
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
                f"{e['busy']}; the run in {time.perf_counter() - t1:.1f} s")
        if quant == "w4a4_packed":
            for part in (prefix_runs, chaos_runs):
                t1 = time.perf_counter()
                launches.append(part(torch))
                say(f"phase 4: {part.__name__} in "
                    f"{time.perf_counter() - t1:.1f} s")
            cut_params = _w4a4_params(RUN_LAYERS["contiguous"])
            for part in (contiguous_runs, compare_runs):
                t1 = time.perf_counter()
                launches.append(part(torch, cut_params, poisson))
                say(f"phase 4: {part.__name__} in "
                    f"{time.perf_counter() - t1:.1f} s")
            del cut_params
        say(f"phase 4: the {quant} runs in {time.perf_counter() - t0:.1f} s")
        del params
    ref = tokens["w4a4_at_depth"]
    if tokens["lut4"] != ref:
        diff = [rid for rid in ref if tokens["lut4"].get(rid) != ref[rid]]
        fail(f"serve (lut4): requests {diff} emitted other tokens than the "
             "w4a4_packed bucketed run at its depth (the integer math is the "
             "same)")
    say("serve (lut4): every request's tokens equal the w4a4_packed "
        "bucketed run's at the same depth, token for token")
    for part in (mamba_runs, hybrid_runs, dense_runs, train_runs):
        t0 = time.perf_counter()
        launches.append(part(torch))
        say(f"phase 4: {part.__name__} in {time.perf_counter() - t0:.1f} s")
    host = DryrunHost()
    try:
        for part in (dist_runs, dryrun_runs):
            t0 = time.perf_counter()
            launches.append(part(torch, host) if part is dryrun_runs
                            else part(torch))
            say(f"phase 4: {part.__name__} in "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        host.stop()
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


# ------------------------------------------------------------- circuit ----
#: 2^24 seeded signed int4 pairs through the netlist as a multiplier array
ARRAY_PAIRS = 1 << 24
#: the oracle forward's prompt: one 16-token prompt at full width
ORACLE_TOKENS = 16
#: the widths run at qwen2-0.5b's projection shapes: every spec but
#: w4a16/w8 takes an exact integer route
WIDTH_SPECS = ("int_sim/a8", "int_sim/w8/a8", "lut4/a8", "pallas_int4/w8/a8",
               "w4a4_packed/a8", "w4a16/w8")
WIDTH_ROWS = (1, MAX_BATCH, 16, 17, 64)
W8_RTOL = 1e-5


def circuit_designs(torch):
    """(a) The proposed multiplier and the two baselines: all 256 pairs on
    the card in both evaluation modes equal a * b; their INIT tables, area,
    timing and the pipelined report printed.  The area and delays are the
    FPGA model's (Artix-7 calibration), not the card's."""
    from repro_torch.core import (analyze, build_acc_mult4, build_lm_mult4,
                                  build_proposed_mult4, resources)
    from repro_torch.core.pipeline_mult import pipelined_report

    a = torch.arange(16, dtype=torch.uint8, device="cuda")[:, None]
    a = a.expand(16, 16).contiguous()
    b = a.t().contiguous()
    exact = (a.int() * b.int()).to(torch.uint8)
    for nl in (build_proposed_mult4(), build_lm_mult4(), build_acc_mult4()):
        for mode in ("direct", "init"):
            got = nl(a, b, mode=mode)
            if not (got.is_cuda and torch.equal(got, exact)):
                fail(f"circuit (a): {nl.name} in {mode} mode is not a * b on "
                     "all 256 pairs on the card")
        r, t = resources(nl), analyze(nl)
        inits = {k: f"0x{v:016X}" for k, v in nl.init_table().items()}
        say(f"circuit (a): {nl.name}: all 256 pairs exact on the card in "
            f"both modes; INIT {json.dumps(inits)}")
        say(f"circuit (a): {nl.name}: FPGA model (not the card): "
            f"{json.dumps(r)}, CPD {t['cpd']:.3f} ns (logic {t['logic']:.3f} "
            f"/ net {t['net']:.3f}), critical output {t['critical_output']}")
        if nl.name == "proposed" and (
                (r["luts"], r["carry4"]) != (11, 2)
                or (t["cpd"], t["logic"], t["net"]) != (2.75, 1.302, 1.448)):
            fail(f"circuit (a): proposed reads {r} and {t}, not 11 LUTs, 2 "
                 "CARRY4 and CPD 2.750 ns (1.302 logic / 1.448 net)")
    say(f"circuit (a): pipelined proposed (FPGA model): "
        f"{json.dumps(pipelined_report())}")


def circuit_array(torch, smi: str):
    """(b) The netlist as a multiplier array: ARRAY_PAIRS seeded signed int4
    pairs split by to_unsigned_mag, multiplied through the circuit in both
    modes and signed again; equal to ops.mul4 (the lut_mul4 kernel) and to
    a * b.  Times each mode and the kernel on the same pairs (`Timer`).
    Returns the launches of the checked run (counted from 0 just
    before)."""
    from repro_torch.core import build_proposed_mult4
    from repro_torch.core.quant import to_unsigned_mag
    from repro_torch.kernels import ops

    nl = build_proposed_mult4()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    a, b = (torch.randint(-8, 8, (ARRAY_PAIRS,), generator=gen,
                          device="cuda", dtype=torch.int8) for _ in range(2))

    def signed(mode):
        ma, sa = to_unsigned_mag(a)
        mb, sb = to_unsigned_mag(b)
        return nl(ma, mb, mode=mode).to(torch.int32) * sa * sb

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    table = ops.mul4(a, b)
    via = {mode: signed(mode) for mode in ("direct", "init")}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    exact = a.int() * b.int()
    for mode, got in via.items():
        if not (got.is_cuda and torch.equal(got, exact)
                and torch.equal(got, table.int())):
            fail(f"circuit (b): the netlist in {mode} mode differs from the "
                 "lut_mul4 kernel or a * b")
    if launches["lut_mul4"] <= 0:
        fail("circuit (b): the lut_mul4 kernel was never launched")
    timer = Timer(torch)
    ms = {mode: timer.ms(lambda m=mode: signed(m), reps=5) for mode in via}
    ms["lut_mul4"] = timer.ms(lambda: ops.mul4(a, b))
    rates = ", ".join(f"{k} {v:.3f} ms ({ARRAY_PAIRS / v * 1e3:.4g} "
                      "products/s)" for k, v in ms.items())
    say(f"circuit (b): {ARRAY_PAIRS} signed int4 pairs through the netlist "
        f"(both modes) equal the lut_mul4 kernel and a * b; {rates}; {smi}")
    return launches


def circuit_oracle(torch):
    """(c) The oracle at full width: qwen2-0.5b, 24 layers, one
    ORACLE_TOKENS-token prompt, float masters from SEED; `forward` under
    `*=netlist` (every product through the circuit) gives logits bit-equal
    to `*=int_sim` (the fused W4A4 kernel) and `*=lut4` (the table-lookup
    kernel).  Prints each forward's time and the netlist run's peak memory.
    Returns the launches (counted from 0 just before the three forwards)."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward, init_model

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_model(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (1, ORACLE_TOKENS), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    logits, secs, peak = {}, {}, {}
    with torch.no_grad():
        for be in ("netlist", "int_sim", "lut4"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rt = Runtime(attn_impl="chunked", quant_plan=f"*={be}")
            logits[be] = forward(params, tokens, cfg, rt)[0]
            torch.cuda.synchronize()
            secs[be] = time.perf_counter() - t0
            peak[be] = torch.cuda.max_memory_allocated() - base
    launches = ops.launch_counts()
    del params
    for be in ("int_sim", "lut4"):
        if not torch.equal(logits["netlist"], logits[be]):
            diff = (logits["netlist"].float() - logits[be].float()).abs()
            fail(f"circuit (c): netlist logits differ from {be}'s (max "
                 f"|diff| {diff.max().item():.6g})")
    want = LAYERS * 7
    for name in ("int4_matmul_fused", "lut4_matmul"):
        if launches[name] != want:
            fail(f"circuit (c): {name} launched {launches[name]} times, not "
                 f"{want} (one a projection)")
    products = sum(m * k * n for m, k, n in _oracle_gemms(cfg))
    say(f"circuit (c): full-width {cfg.name} ({cfg.n_layers} layers), "
        f"{ORACLE_TOKENS} tokens, bf16: *=netlist logits "
        f"{tuple(logits['netlist'].shape)} bit-equal to *=int_sim (fused "
        f"W4A4 kernel) and *=lut4; {products} products through the "
        f"circuit; host seconds with sync: "
        + ", ".join(f"{be} {secs[be]:.3f} s (peak {peak[be] / 2**30:.3f} GiB "
                    "above the weights)" for be in secs))
    return launches


def _oracle_gemms(cfg):
    """(M, K, N) of every projection of one forward of ORACLE_TOKENS."""
    D, F, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    layer = [(D, cfg.n_heads * cfg.hd), (D, kv), (D, kv),
             (cfg.n_heads * cfg.hd, D), (D, F), (D, F), (F, D)]
    return [(ORACLE_TOKENS, k, n) for k, n in layer] * cfg.n_layers


def width_call(torch, spec: str, w, x, pw=None):
    """`*=spec` through `qdense` on w [K, N] and x [M, K], held to its
    float64 reference: returns (result, relative error).  The integer
    routes must equal a float64 integer GEMM of the quantized values with
    the same epilogue bit for bit (error 0.0, else inf); w4a16/w8 reads the
    largest |difference| from a float64 product of the dequantized weight
    over that product's largest magnitude.  `pw` is the packed weight of a
    packed spec (packed here when None)."""
    from repro_torch.core import qlinear as tql
    from repro_torch.core.quant import (group_dequantize, group_quantize,
                                        quant_scale, quantize, unpack_int4)
    from repro_torch.core.quant_plan import get_plan

    qc = get_plan(f"*={spec}").resolve("x")
    K = w.shape[0]
    if qc.backend == "w4a16":
        got = tql.qdense(w, x, qc)
        w_q, w_s = group_quantize(w, K, bits=qc.w_bits)
        want = x.double() @ group_dequantize(w_q, w_s, K).double()
        return got, ((got.double() - want).abs().max()
                     / want.abs().max()).item()
    if qc.backend == "w4a4_packed":
        if pw is None:
            pw = tql.prepack_tree({"w": tql.pack_weight_nd(w, qc)})["w"]
        got = tql.qdense(pw, x, qc)
        w_q, w_s = unpack_int4(pw["packed"], axis=-1), pw["scale"]
    else:
        got = tql.qdense(w, x, qc)
        w_s = quant_scale(w, axis=0, bits=qc.w_bits)
        w_q = quantize(w, w_s, bits=qc.w_bits)
    a_s = quant_scale(x, axis=1, bits=qc.a_bits)
    acc = quantize(x, a_s, bits=qc.a_bits).double() @ w_q.double()
    exact = torch.equal(got, acc.to(torch.float32) * a_s * w_s)
    return got, 0.0 if exact else math.inf


def circuit_widths(torch):
    """(d) Widths no kernel serves, at WIDTH_ROWS rows on qwen2-0.5b's
    projection shapes, each held to its float64 reference (`width_call`):
    the integer routes (torch._int_mm, padded) bit for bit, w4a16/w8 within
    W8_RTOL.  Every result stays on the card and no kernel launches."""
    from repro_torch.core import qlinear as tql
    from repro_torch.core.quant_plan import get_plan
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    t0 = time.perf_counter()
    worst = 0.0
    n = 0
    ops.reset_launch_counts()
    for (K, N), _ in GEMM_SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
        qc = get_plan("*=w4a4_packed/a8").resolve("x")
        pw = tql.prepack_tree({"w": tql.pack_weight_nd(w, qc)})["w"]
        for M in WIDTH_ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda")
            for spec in WIDTH_SPECS:
                got, err = width_call(torch, spec, w, x, pw)
                if spec == "w4a16/w8":
                    worst = max(worst, err)
                if not (got.is_cuda and err <= W8_RTOL):
                    fail(f"circuit (d): *={spec} at M={M}, K={K}, N={N} is "
                         f"not the float64 reference on the card ({err})")
                n += 1
    torch.cuda.synchronize()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        fail(f"circuit (d): the width routes launched kernels {launched}")
    say(f"circuit (d): {n} width calls ({', '.join(WIDTH_SPECS)} at M = "
        f"{', '.join(map(str, WIDTH_ROWS))} on {len(GEMM_SHAPES)} projection "
        f"shapes): integer routes bit-equal to a float64 integer GEMM, "
        f"w4a16/w8 within {worst:.3g} relative (limit {W8_RTOL}), on the "
        f"card, no kernel launched; {time.perf_counter() - t0:.1f} s")


def _held_to_plain(torch, ops, worst: dict):
    """A context in which `ops`' GEMM entry points run their kernel and
    then its plain version on the same inputs, and fail the run unless the
    two agree as phase 3 holds them: the W4A4 and table kernels bit for
    bit, the W4A16 kernel within W4A16_RTOL of the output's largest
    magnitude.  `worst` collects, per kernel, the calls held and the
    largest |difference|.  The plain versions launch nothing."""
    import contextlib

    from repro_torch.kernels.int4_matmul import int4_matmul_fused_plain
    from repro_torch.kernels.lut4_matmul import lut4_matmul_plain
    from repro_torch.kernels.w4a16_matmul import w4a16_matmul_plain

    held = {"int4_matmul_fused_kmajor": ("int4_matmul_fused",
                                         int4_matmul_fused_plain, 0.0),
            "lut4_matmul_kmajor": ("lut4_matmul", lut4_matmul_plain, 0.0),
            "w4a16_matmul_kmajor": ("w4a16_matmul", w4a16_matmul_plain,
                                    W4A16_RTOL)}

    def holding(entry, name, plain, rtol):
        def call(*args, **kwargs):
            got = entry(*args, **kwargs)
            want = plain(*args)
            err = (got - want).abs().max().item()
            if not (got.is_cuda and err <= rtol * want.abs().max().item()):
                fail(f"circuit (e): kernel {name} at {tuple(args[0].shape)} "
                     f"-> {tuple(got.shape)} differs from its plain version "
                     f"(max |diff| {err:.6g})")
            n, top = worst.get(name, (0, 0.0))
            worst[name] = (n + 1, max(top, err))
            return got
        return call

    @contextlib.contextmanager
    def ctx():
        saved = {attr: getattr(ops, attr) for attr in held}
        for attr, (name, plain, rtol) in held.items():
            setattr(ops, attr, holding(saved[attr], name, plain, rtol))
        try:
            yield
        finally:
            for attr, entry in saved.items():
                setattr(ops, attr, entry)
    return ctx()


def circuit_sweep(torch):
    """(e) The sensitivity sweep on full-width qwen2-0.5b (batch 2, seq 16,
    seed 0) on the card: the table printed with its seconds; the int_sim and
    lut4 backend rows equal; every quantized MSE finite and above 0.  Then
    the uniform forward of each COMPARE_BACKENDS plan, on the sweep's params
    and tokens, with every kernel call held to its plain version at the
    sweep's own shapes (`_held_to_plain`).  Returns the launches of the
    sweep (counted from 0 just before)."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.sensitivity import (COMPARE_BACKENDS,
                                                sensitivity_sweep)
    from repro_torch.models.transformer import forward, init_model

    cfg = get_config("qwen2-0.5b")
    batch, seq, seed = 2, 16, 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = sensitivity_sweep(cfg, seed=seed, params=params, tokens=tokens,
                            device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    rows = {r["backend"]: r["mse_vs_float"] for r in rep["backends"]}
    mses = [rep["uniform_mse_vs_float"]] + list(rows.values()) \
        + [r["mse_vs_float"] for r in rep["per_site"]]
    if rows["int_sim"] != rows["lut4"]:
        fail(f"circuit (e): the int_sim and lut4 rows differ: {rows}")
    if not all(math.isfinite(m) and m > 0 for m in mses):
        fail(f"circuit (e): a quantized MSE is not finite and above 0: "
             f"{json.dumps(rep)}")
    for name in ("int4_matmul_fused", "lut4_matmul", "w4a16_matmul"):
        if launches[name] <= 0:
            fail(f"circuit (e): kernel {name} was never launched")
    say(f"circuit (e): sensitivity sweep, full-width {cfg.name}, batch "
        f"{batch}, seq {seq}, seed {seed}, on the card in {secs:.2f} s: "
        f"{json.dumps(rep)}")
    worst = {}
    with torch.no_grad(), _held_to_plain(torch, ops, worst):
        for spec in COMPARE_BACKENDS.values():
            rt = Runtime(attn_impl="chunked", attn_chunk_q=min(512, seq),
                         quant_plan=spec)
            forward(params, tokens, cfg, rt)
    torch.cuda.synchronize()
    for name in ("int4_matmul_fused", "lut4_matmul", "w4a16_matmul"):
        if worst.get(name, (0,))[0] <= 0:
            fail(f"circuit (e): no {name} call was held to its plain version")
    say("circuit (e): the uniform forwards of "
        f"{', '.join(COMPARE_BACKENDS.values())} with every kernel call held "
        "to its plain version: "
        + ", ".join(f"{k} {n} calls, max |diff| {e:.6g}"
                    for k, (n, e) in worst.items())
        + f" (W4A4 and table bit-equal, W4A16 limit {W4A16_RTOL} relative)")
    return launches


def circuit_runs(torch, smi: str):
    """The paper's circuit on the card, (a) to (e); returns the launches of
    (b), (c) and (e), summed."""
    t0 = time.perf_counter()
    circuit_designs(torch)
    launches = [circuit_array(torch, smi), circuit_oracle(torch)]
    circuit_widths(torch)
    launches.append(circuit_sweep(torch))
    say(f"circuit: (a) to (e) in {time.perf_counter() - t0:.1f} s")
    return {k: sum(n[k] for n in launches) for k in launches[0]}

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
    run's GEMM launched `gemms_a_forward` times per step and its
    decode attention kernel once a layer (none for NO_DECODE_KERNEL; a replay
    counts its graph's launches).  Runs
    after the serve run has read its launch counts.  `mode` ("graphs" or
    "eager") names the engine's steps in the output.  Returns the step's
    ms, host launches, device kernels and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    step = SERVE_RUNS[run][0] if run in SERVE_RUNS else "bucketed"
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
    layers = engine.cfg.n_layers
    n_gemm = gemms_a_forward(engine.cfg)
    if per_step.get(gemm) != n_gemm or any(
            per_step.get(k) for k in ("int4_matmul_fused", "w4a16_matmul",
                                      "lut4_matmul") if k != gemm):
        fail(f"profile ({label}): kernel launches per decode step {per_step}; "
             f"want {n_gemm} of {gemm} and no other GEMM")
    attn = (None if run in NO_DECODE_KERNEL
            else "paged_decode_attention" if step == "bucketed"
            else "ragged_decode_attention")
    if attn is None:
        if any(per_step.get(k) for k in ATTN_KERNELS):
            fail(f"profile ({label}): kernel launches per decode step "
                 f"{per_step}; want no attention kernel")
    elif per_step.get(attn) != layers:
        fail(f"profile ({label}): kernel launches per decode step {per_step}; "
             f"want {layers} of {attn}, one a layer")
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
    if attn is not None:
        mine = [e for e in kernels
                if attn.replace("_attention", "_kernel") in e.key]
        say(f"profile ({label}): the {attn} kernels: "
            f"{sum(dev_us(e) for e in mine) / steps / 1e3:.3f} ms/step of "
            f"device time, {sum(e.count for e in mine) / steps:.0f} "
            "launches/step")
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
def _two_devices(torch, rt, arch="qwen2-0.5b", prompt_len=(40, 64),
                 routes=None):
    """`arch` at full width cut to 2 layers, the same weights on both
    devices: one prefill of a left-padded prompt (`prompt_len`: its tokens
    and the padded length) and three decode steps fed fixed tokens (so a
    flipped argmax cannot send the two runs down different paths).  With
    `routes` (a dict), the expert ids each MoE block routed to are
    appended under each device, call by call.  Returns {device: logits [4,
    vocab] f32 on the CPU} and the launch counts of the card's run."""
    from unittest import mock

    from repro_torch.configs import ServingConfig, get_config
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving.engine import build_params
    from repro_torch.serving.kv_pages import (init_paged_caches,
                                              with_block_tables)

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    sv = ServingConfig(layout="paged", max_batch=1, page_size=PAGE_SIZE,
                       num_pages=8, max_ctx=128)
    params_gpu = build_params(cfg, rt, seed=SEED + 5, device="cuda")
    params_cpu = tree_to(params_gpu, "cpu")
    gen = torch.Generator().manual_seed(SEED + 6)
    L, Lb = prompt_len
    prompt = torch.randint(0, cfg.vocab, (L,), generator=gen)
    feed = torch.randint(0, cfg.vocab, (3,), generator=gen)
    tokens = torch.zeros((1, Lb), dtype=torch.int32)
    tokens[0, Lb - L:] = prompt
    base = torch.arange(Lb, dtype=torch.int32) - (Lb - L)
    positions = torch.where(base >= 0, base, -1)[None]
    tbl = torch.arange(sv.pages_per_seq, dtype=torch.int32)[None]
    logits = {}
    real = moe._moe_shard

    def shard(*args, **kw):
        route = {}
        out = real(*args, dispatch=route, **kw)
        routes[dev].append(route["idx"].cpu())
        return out

    with torch.inference_mode(), mock.patch.object(
            moe, "_moe_shard", shard if routes is not None else real):
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if routes is not None:
                routes[dev] = []
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


def _two_devices_mamba(torch):
    """Full-width mamba2-130m (all 24 layers), the serving path's W4A4
    weights in float32, the same weights on both devices: one prefill of a
    40-token prompt (exact length) on contiguous caches and three decode
    steps fed fixed tokens.  Returns {device: logits [4, vocab] f32 on
    the CPU} and the launch counts of the card's run."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                prefill)
    from repro_torch.serving.engine import build_params

    cfg = get_config("mamba2-130m")
    rt = Runtime(quant_backend="w4a4_packed", compute_dtype="float32")
    params_gpu = build_params(cfg, rt, seed=SEED + 5, device="cuda")
    params_cpu = tree_to(params_gpu, "cpu")
    gen = torch.Generator().manual_seed(SEED + 8)
    L = 40
    prompt = torch.randint(0, cfg.vocab, (1, L), generator=gen).to(
        torch.int32)
    feed = torch.randint(0, cfg.vocab, (3,), generator=gen)
    logits = {}
    with torch.inference_mode():
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if dev == "cuda":
                ops.reset_launch_counts()
            caches = init_caches(cfg, rt, batch=1, seq=128, device=dev)
            lg, caches = prefill(params, prompt.to(dev), cfg, rt, caches)
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


def _two_devices_hybrid(torch):
    """Full-width recurrentgemma-9b cut to one (R, R, A) unit and the (R, R)
    tail (5 layers; the full depth's CPU forward would need ~40 GB of host
    memory), the serving path's W4A4 weights in float32 and a float32
    cache, the same weights on both devices: one prefill of a 40-token
    prompt (exact length, chunked exact attention: flash is bf16 only) on
    contiguous caches and three decode steps fed fixed tokens.  Returns
    {device: logits [4, vocab] f32 on the CPU} and the launch counts of
    the card's run."""
    from repro_torch.configs import Runtime, get_config
    from repro_torch.convert import tree_to
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                prefill)
    from repro_torch.serving.engine import build_params

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    rt = Runtime(quant_backend="w4a4_packed", compute_dtype="float32",
                 cache_dtype="float32")
    params_gpu = build_params(cfg, rt, seed=SEED + 6, device="cuda")
    params_cpu = tree_to(params_gpu, "cpu")
    gen = torch.Generator().manual_seed(SEED + 9)
    L = 40
    prompt = torch.randint(0, cfg.vocab, (1, L), generator=gen).to(
        torch.int32)
    feed = torch.randint(0, cfg.vocab, (3,), generator=gen)
    logits = {}
    with torch.inference_mode():
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            if dev == "cuda":
                ops.reset_launch_counts()
            caches = init_caches(cfg, rt, batch=1, seq=128, device=dev)
            lg, caches = prefill(params, prompt.to(dev), cfg, rt, caches)
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
    return logits, launches, gemms_a_forward(cfg)


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


#: phase 5's GELU and MoE readings: the config and its prompt (tokens,
#: padded length).  arctic-480b's prompt is short: the CPU dequantizes the
#: experts a step's rows route to, at most 32 of the 128 for 16 rows at
#: top-2, as the card does
CPU_GELU_MOE = (("starcoder2-7b", (40, 64)), ("arctic-480b", (12, 16)))


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
    JAX package.  Then full-width mamba2-130m (`_two_devices_mamba`):
    W4A4 weights in float32, a prefill and three decode steps on
    contiguous caches, logits within CPU_W4A4_F32_ATOL; last, full-width
    recurrentgemma-9b at 5 layers (`_two_devices_hybrid`), the same
    reading and bound.  Before those, starcoder2-7b and arctic-480b at
    full width, 2 layers (CPU_GELU_MOE), W4A4 weights in float32: for
    arctic the expert ids every MoE block routed to must be equal on both
    devices (any flipped assignment is printed), then the logits within
    CPU_W4A4_F32_ATOL for both.
    """
    from repro_torch.configs import Runtime, get_config

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
    for arch in ("qwen3-4b", "qwen2-vl-2b"):
        for what, rt, atol, kernel in (
                ("W4A4 weights, float32", Runtime(
                    attn_impl="chunked", paged_attn="gather",
                    quant_backend="w4a4_packed", compute_dtype="float32",
                    cache_dtype="float32"), CPU_W4A4_F32_ATOL,
                 "int4_matmul_fused"),
                ("float weights, bf16", Runtime(
                    attn_impl="flash", quant_backend="float"), CPU_ATOL,
                 "paged_decode_attention")):
            logits, launches = _two_devices(torch, rt, arch)
            what = (f"{arch}, {what}, 2 layers at full width, prefill + 3 "
                    "decode steps")
            err, _ = _compare(torch, what, logits, launches)
            readings[what] = err
            if launches[kernel] <= 0:
                fail(f"cpu: {what}: the card's run never launched {kernel}")
            if err > atol:
                fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} "
                     f"> {atol}")
    f32 = Runtime(attn_impl="chunked", paged_attn="gather",
                  quant_backend="w4a4_packed", compute_dtype="float32",
                  cache_dtype="float32")
    for arch, prompt_len in CPU_GELU_MOE:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        routes = {} if cfg.family == "moe" else None
        logits, launches = _two_devices(torch, f32, arch, prompt_len, routes)
        what = (f"{arch}, W4A4 weights, float32, 2 layers at full width, "
                f"prefill of {prompt_len[0]} tokens (padded to "
                f"{prompt_len[1]}) + 3 decode steps")
        if routes is not None:
            gpu, cpu = routes["cuda"], routes["cpu"]
            flips = [(c, t, a[t].tolist(), b[t].tolist())
                     for c, (a, b) in enumerate(zip(gpu, cpu))
                     for t in range(a.shape[0]) if not torch.equal(a[t], b[t])]
            say(f"cpu: {what}: the routed expert ids of {len(gpu)} MoE calls "
                f"({sum(r.numel() for r in gpu)} assignments): "
                f"{len(flips)} differ between card and CPU"
                + "".join(f"; call {c} row {t}: card {a}, cpu {b}"
                          for c, t, a, b in flips))
            if flips or len(gpu) != len(cpu) or not gpu:
                fail(f"cpu: {what}: the card and the CPU routed tokens to "
                     "other experts")
        err, _ = _compare(torch, what, logits, launches)
        readings[what] = err
        if launches["int4_matmul_fused"] != gemms_a_forward(cfg) * 4:
            fail(f"cpu: {what}: the card's run launched the W4A4 GEMM "
                 f"{launches['int4_matmul_fused']} times, want "
                 f"{gemms_a_forward(cfg) * 4}")
        if err > CPU_W4A4_F32_ATOL:
            fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} > "
                 f"{CPU_W4A4_F32_ATOL}")
    logits, launches = _two_devices_mamba(torch)
    what = ("mamba2-130m, W4A4 weights, float32, 24 layers at full width, "
            "prefill + 3 decode steps")
    err, _ = _compare(torch, what, logits, launches)
    readings[what] = err
    if launches["int4_matmul_fused"] != 2 * 24 * 4:
        fail(f"cpu: {what}: the card's run launched the W4A4 GEMM "
             f"{launches['int4_matmul_fused']} times, want {2 * 24 * 4}")
    if err > CPU_W4A4_F32_ATOL:
        fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} > "
             f"{CPU_W4A4_F32_ATOL}")
    logits, launches, per_forward = _two_devices_hybrid(torch)
    what = ("recurrentgemma-9b, W4A4 weights, float32, one (R, R, A) unit "
            "and the (R, R) tail at full width, prefill + 3 decode steps")
    err, _ = _compare(torch, what, logits, launches)
    readings[what] = err
    if launches["int4_matmul_fused"] != per_forward * 4:
        fail(f"cpu: {what}: the card's run launched the W4A4 GEMM "
             f"{launches['int4_matmul_fused']} times, want {per_forward * 4}")
    if err > CPU_W4A4_F32_ATOL:
        fail(f"cpu: {what}: card and CPU logits differ by {err:.6g} > "
             f"{CPU_W4A4_F32_ATOL}")
    return readings


# ------------------------------------------------- analysis and tuning ----
#: the tune phase's GEMMs at qwen2-0.5b's w_in / w_gate (K 896, N 4864):
#: (op, activation dtype, group size, M)
TUNE_CASES = (("int4_matmul", "float32", 0, MAX_BATCH),
              ("int4_matmul", "float32", 0, PROMPT_BUCKET),
              ("gemm.lut4", "int8", 0, MAX_BATCH),
              ("w4a16_matmul", "bfloat16", 128, MAX_BATCH))
TUNE_K, TUNE_N = 896, 4864
#: ... and the attention ops at the main path's shapes: (op, case): the
#: paged decode batch of `check_decode` (qwen2-0.5b, B = 8, ps 16, a
#: 512-token table, bf16 pool), the ragged serving pack of `check_ragged`
#: (T = 64: 8 decode rows, a 48-row chunk, 8 padding; int8 pool), and
#: flash prefill fresh 256 at hd 64 (qwen2-0.5b) and hd 128 (qwen3-4b)
TUNE_ATTN_CASES = (("attn.paged_decode", "decode"),
                   ("attn.ragged", "ragged"),
                   ("attn.prefill", "fresh256"),
                   ("attn.prefill", "hd128"))


def analysis_run() -> dict:
    """The port's static analyzer (``python -m repro_torch.analysis``, its
    default paths) over the tree as shipped, against
    analysis_baseline_torch.json: it must exit 0.  Its counts."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--baseline",
         "analysis_baseline_torch.json", "--format", "json"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"analysis: exit {out.returncode}\n{out.stdout[-4000:]}\n"
             f"{out.stderr[-4000:]}")
    counts = json.loads(out.stdout)["counts"]
    say(f"analysis: {json.dumps(counts, sort_keys=True)}")
    if counts["new"] or counts["stale_baseline"]:
        fail(f"analysis: new or stale findings {counts}")
    return counts


def _tune_gemm(torch, gen, op, dtype, G, M):
    """A `TUNE_CASES` GEMM at (M, TUNE_K, TUNE_N) on the card: `run(plan)`
    launches the op's CUDA wrapper (None: the cache's or the rule's plan),
    `held(out)` is its max |diff| to the plain version and whether that is
    within the op's limit (the integer GEMMs bit for bit, W4A16 within
    W4A16_RTOL of the output's largest magnitude), `launch_plan()` the
    plan the wrapper would take, read with nothing launched."""
    from repro_torch.core.quant import group_quantize, quant_scale, quantize
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lut4_matmul as l4
    from repro_torch.kernels import w4a16_matmul as w16
    from repro_torch.kernels.packing import pack_kmajor

    K, N = TUNE_K, TUNE_N
    x, w_q, w_km, w_scale = _gemm_inputs(torch, gen, M, K, N)
    aligned = w_km.data_ptr() % 16 == 0
    if op == "int4_matmul":
        run, plain, launch_plan = (
            lambda plan=None: i4.int4_matmul_fused_cuda(x, w_km, w_scale,
                                                        plan=plan),
            i4.int4_matmul_fused_plain(x, w_km, w_scale),
            lambda: i4.launch_plan(M, K, N, w_km.shape[0], aligned, dtype))
    elif op == "gemm.lut4":
        a_scale = quant_scale(x, axis=1, bits=4)
        a_q = quantize(x, a_scale, bits=4)
        run, plain, launch_plan = (
            lambda plan=None: l4.lut4_matmul_cuda(a_q, a_scale, w_km,
                                                  w_scale, plan=plan),
            l4.lut4_matmul_plain(a_q, a_scale, w_km, w_scale),
            lambda: l4.launch_plan(M, K, N, w_km.shape[0], aligned))
    else:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.05
        wq, ws = group_quantize(w, G)
        w_km = pack_kmajor(wq, 2 * G).contiguous()
        xb = x.to(torch.bfloat16)
        run, plain, launch_plan = (
            lambda plan=None: w16.w4a16_matmul_cuda(xb, w_km, ws, G,
                                                    plan=plan),
            w16.w4a16_matmul_plain(xb, w_km, ws, G),
            lambda: w16.launch_plan(M, K, N, w_km.shape[0], G, True,
                                    xb.data_ptr() % 16 == 0,
                                    w_km.data_ptr() % 16 == 0))

    def held(out):
        err = (out - plain).abs().max().item()
        if op == "w4a16_matmul":
            return err, err <= W4A16_RTOL * plain.abs().max().item()
        return err, torch.equal(out, plain)

    return {"label": f"{op} {dtype} G={G} M={M} K={K} N={N}",
            "key": (M, K, N, dtype, G), "run": run, "held": held,
            "pair": None, "launch_plan": launch_plan}


def _tune_attn(torch, gen, op, case):
    """A `TUNE_ATTN_CASES` attention op on the card, as `_tune_gemm`
    returns a GEMM: `held(out)` is within ATTN_ATOL of the plain version
    with idle and padding rows exactly zero; for the decode ops `pair(plan)`
    holds a decode-only ragged pack bit-equal to the paged decode kernel
    under the split."""
    from repro_torch.kernels.autotune import attn_default_blocks
    from repro_torch.kernels.paged_attention import (
        POOL_NAMES, decode_plan_for, flash_launch_plan, flash_prefill_cuda,
        flash_prefill_plain, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    from repro_torch.kernels.ragged_attention import (
        ragged_decode_attention_cuda, ragged_decode_attention_plain)

    ps, pps = PAGE_SIZE, DECODE_PPS
    if op == "attn.prefill":
        Sq, Skv, n_real, hit, nh, nkv, hd = FLASH_CASES[case]
        q, k, v, qpos, kpos = _flash_inputs(torch, gen, Sq, Skv, n_real, hit,
                                            nh, nkv, hd)
        bk = attn_default_blocks("attn.prefill", Sq, Skv, nh * hd)["bk"]
        plain = flash_prefill_plain(q, k, v, qpos, kpos, bk=bk)
        zero = qpos[0] < 0

        def run(plan=None):
            return flash_prefill_cuda(q, k, v, qpos, kpos, plan=plan)

        def held(out):
            err = (out.float() - plain.float()).abs().max().item()
            return err, err <= ATTN_ATOL and not out[0, zero].any()

        return {"label": f"{op} {case}: B=1, Sq={Sq}, Skv={Skv}, H={nh}, "
                         f"KV={nkv}, hd={hd}",
                "key": ((1, Sq), Skv, (nh, hd), "bfloat16", nkv),
                "run": run, "held": held, "pair": None,
                "launch_plan": lambda: flash_launch_plan(1, Sq, Skv, nh, nkv,
                                                         hd)}
    pp = max(1, attn_default_blocks(op, MAX_BATCH, pps * ps, H * HD,
                                    group_size=ps)["bk"] // ps)
    if op == "attn.paged_decode":
        q, tbl, lp, pools = decode_inputs(torch, gen)
        k, v, ks, vs = pools["bfloat16"]
        plain = paged_decode_attention_plain(q, k, v, tbl, lp, pp=pp)
        zero = lp < 0
        dq, dtbl, dpos = q, tbl, lp
        dslot = torch.arange(len(lp), dtype=torch.int32, device="cuda")
        label = (f"{op}: B={len(lp)}, H={H}, KV={KV}, hd={HD}, ps={ps}, "
                 f"{pps * ps}-token table, bf16 pool")

        def run(plan=None):
            return paged_decode_attention_cuda(q, k, v, tbl, lp, plan=plan)
    else:
        slot, pos, row_last = _ragged_pack(torch)
        tbl = _table(torch, gen, len(row_last), 320, pps, row_last)
        q = torch.randn((slot.shape[0], H, HD), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v, ks, vs = _pools(torch, gen, 320, ps)["int8"]
        plain = ragged_decode_attention_plain(q, k, v, tbl, slot, pos, ks,
                                              vs, pp=pp)
        zero = (slot < 0) | (pos < 0)
        n_dec = len(row_last) - 1
        dq, dtbl, dpos, dslot = (t[:n_dec].contiguous()
                                 for t in (q, tbl, pos, slot))
        label = (f"{op}: T={slot.shape[0]} ({n_dec} decode rows, a 48-row "
                 f"chunk, {int(zero.sum())} padding), H={H}, KV={KV}, "
                 f"hd={HD}, ps={ps}, int8 pool")

        def run(plan=None):
            return ragged_decode_attention_cuda(q, k, v, tbl, slot, pos, ks,
                                                vs, plan=plan)

    def held(out):
        err = (out.float() - plain.float()).abs().max().item()
        return err, err <= ATTN_ATOL and not out[zero].any()

    def pair(plan):
        paged = paged_decode_attention_cuda(dq, k, v, dtbl, dpos, ks, vs,
                                            plan=plan)
        rag = ragged_decode_attention_cuda(dq, k, v, dtbl, dslot, dpos, ks,
                                           vs, plan=plan)
        return torch.equal(paged, rag)

    return {"label": label,
            "key": (KV, pps * ps, HD, POOL_NAMES[k.dtype], ps), "run": run,
            "held": held, "pair": pair,
            "launch_plan": lambda: decode_plan_for(tbl, k)}


def _plan_host_us(held, calls: int = 20000) -> list:
    """Host us of one `launch_plan()` (the plan a wrapper cuts, with
    nothing launched) for each tuned case: the mean of `calls` calls."""
    out = []
    for case in held:
        launch_plan = case["launch_plan"]
        t0 = time.perf_counter()
        for _ in range(calls):
            launch_plan()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def tune_runs(torch) -> dict:
    """The plans' timed search (``kernels.autotune.tune``, its CUDA-event
    timer: device time a call, L2 flushed) at TUNE_CASES and
    TUNE_ATTN_CASES, into the script's own cache file
    ($REPRO_AUTOTUNE_CACHE, set by main): each candidate's us, the rule's
    and the winner's; every timed candidate's output, not only the
    winner's, held to the plain version (the integer GEMMs bit for bit,
    W4A16 within W4A16_RTOL of the output's largest magnitude, attention
    within ATTN_ATOL with idle and padding rows exactly zero), since a
    cache file may hold any of them, and under every decode split a
    decode-only ragged pack bit-equal to the paged decode kernel; then the
    cache saved, dropped, read back, and the wrapper's plan for each shape
    the tuned entry, launched bit-equal to the winner's call, and the
    host's cost of the wrapper's plan with the cache loaded, empty and not
    read (`_plan_host_us`).  The cache is dropped again and its file
    removed at the end."""
    from repro_torch.kernels import autotune

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    cases = [dict(_tune_gemm(torch, gen, *c), op=c[0])
             for c in TUNE_CASES] \
        + [dict(_tune_attn(torch, gen, op, c), op=op)
           for op, c in TUNE_ATTN_CASES]
    report = {}
    for case in cases:
        op, label, run = case["op"], case["label"], case["run"]
        M, K, N, dtype, G = case["key"]
        rows = []

        def make_call(entry, run=run):
            def call():
                return run(entry)
            call.entry = entry
            return call

        def timer(fn, rows=rows, case=case):
            us = autotune._default_timer(fn)
            err, ok = case["held"](fn())
            paired = case["pair"] is None or case["pair"](fn.entry)
            rows.append((fn.entry, us, err, ok, paired))
            return us

        best, best_us = autotune.tune(op, make_call, M, K, N, dtype,
                                      group_size=G, timer=timer)
        rule = autotune.tuning(op).rule(M, K, N, G, dtype)
        rule_us = next(r[1] for r in rows if r[0] == rule)
        for entry, us, err, ok, paired in rows:
            say(f"tune: {label}: {json.dumps(entry, sort_keys=True)} "
                f"{us:.2f} us, max |diff| to plain {err:.6g}"
                f"{'' if ok else ' DIFFERS'}"
                + ("" if case["pair"] is None else
                   ", decode-only ragged pack == paged decode" if paired
                   else ", decode-only ragged pack DIFFERS from paged"))
        wrong = [r[0] for r in rows if not (r[3] and r[4])]
        if wrong:
            fail(f"tune: {label}: {len(wrong)} of {len(rows)} candidates "
                 f"differ from the plain version or, for decode, break the "
                 f"ragged pack's bit-equality with paged decode: {wrong}")
        got = run(best)
        err, ok = case["held"](got)
        say(f"tune: {label}: rule {json.dumps(rule, sort_keys=True)} "
            f"{rule_us:.2f} us, winner {json.dumps(best, sort_keys=True)} "
            f"{best_us:.2f} us ({best_us / rule_us:.3f} of the rule's) of "
            f"{len(rows)} timed; max |diff| to plain {err:.6g}")
        if not (math.isfinite(best_us) and ok):
            fail(f"tune: {label}: the winner {best} differs from the plain "
                 f"version by {err:.6g}")
        report[label] = {"rule": rule, "rule_us": rule_us, "best": best,
                         "best_us": best_us, "timed": len(rows),
                         "max_abs_err": err,
                         "candidates_max_abs_err": max(r[2] for r in rows),
                         "candidates_us": [(r[0], r[1]) for r in rows]}
        case.update(best=best, got=got)
    path = autotune.cache_path()
    autotune.reset()
    n = autotune.load_cache()
    if n != len(cases):
        fail(f"tune: {path} held {n} entries after a reload, want "
             f"{len(cases)}")
    for case in cases:
        op, best = case["op"], case["best"]
        M, K, N, dtype, G = case["key"]
        cached = autotune.lookup(op, M, K, N, dtype, G)
        want = autotune.tuning(op).check(best, M, K, N, G, dtype)
        plan = case["launch_plan"]()
        if cached != best or plan != want:
            fail(f"tune: after the reload {case['label']} takes {plan} "
                 f"(cache {cached}), not the tuned {want}")
        if not torch.equal(case["run"](), case["got"]):
            fail(f"tune: {case['label']}: the cached plan's launch differs "
                 "from the winner's call")
    hit = _plan_host_us(cases)
    autotune.reset()
    os.remove(path)
    autotune.ensure_loaded()                  # the file is gone: empty
    empty = _plan_host_us(cases)
    real = autotune.tuned_plan
    autotune.tuned_plan = lambda *a, **kw: None
    try:
        rule_only = _plan_host_us(cases)
    finally:
        autotune.tuned_plan = real
    autotune.reset()
    for case, h, e, r in zip(cases, hit, empty, rule_only):
        say(f"tune: host us a wrapper's plan, {case['label']}: cache loaded "
            f"{h:.3f}, cache empty {e:.3f}, cache not read {r:.3f}")
        report[f"host {case['label']}"] = {
            "plan_us_cache_loaded": h, "plan_us_cache_empty": e,
            "plan_us_no_lookup": r}
    worst = max(h - e for h, e in zip(hit, empty))
    say(f"tune: {n} entries saved to, reloaded from and removed with "
        f"{path}; each wrapper took its tuned plan; a loaded cache costs a "
        f"wrapper's plan at most {worst:.3f} host us over an empty one")
    return report


#: the tuned-cache serve check's depth (full width)
TUNED_SERVE_LAYERS = 8
#: the plans its cache file holds for the main path's attention, neither
#: the rule's: a 4-way split of the 512-token serving table, and a flash
#: plan of 32 rows a CTA shared by 2 warps a row tile
TUNED_SERVE_SPLIT = {"split_tok": 128, "nsplit": 4}
TUNED_SERVE_FLASH = {"rows": 32, "key_split": 2}


def tuned_serve_run(torch) -> dict:
    """The bucketed bf16 W4A4 path (full-width qwen2-0.5b at
    TUNED_SERVE_LAYERS layers, the Poisson trace, captured steps) served
    with a cache file that cuts its attention otherwise than the rules
    (TUNED_SERVE_SPLIT at the serving table, TUNED_SERVE_FLASH at every
    fresh prompt bucket and batch), and again with no cache file: the
    engine loads the file when built, its decode launches take the tuned
    split, and the two runs' greedy tokens are compared request by request.
    A split or a flash plan changes only the order of the online softmax's
    sums, so in bf16 the tokens may part as the step modes' do (ROADMAP
    Queue 3 item 14): the agreement is reported, every request must be
    ok."""
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_attention import decode_plan_for
    from repro_torch.serving.api import poisson_trace

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              n_layers=TUNED_SERVE_LAYERS)
    params = _w4a4_params(TUNED_SERVE_LAYERS)
    trace = poisson_trace(8, 0.5, PROMPT_LENS, GEN_LENS, cfg.vocab,
                          seed=SEED)
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed")
    entries = {autotune.cache_key("attn.paged_decode", KV, 512, HD,
                                  "bfloat16", PAGE_SIZE): TUNED_SERVE_SPLIT}
    for B in range(1, MAX_BATCH + 1):
        for Sq in sorted({ServingConfig.prompt_bucket(n)
                          for n in PROMPT_LENS}):
            entries[autotune.cache_key("attn.prefill", (B, Sq), Sq, (H, HD),
                                       "bfloat16", KV)] = TUNED_SERVE_FLASH
    path = autotune.cache_path()
    with open(path, "w") as f:
        json.dump(entries, f)
    tokens = {}
    for which in ("tuned", "rules"):
        autotune.reset()
        engine, _, _, tokens[which] = serve_engine(
            torch, cfg, params, rt, _sv(), trace, PROMPT_LENS,
            f"bucketed at {cfg.n_layers} layers, {which} attention plans")
        pool = engine.caches["rep"]["u0"]["attn"]["k"][0]
        split = decode_plan_for(engine._tbl, pool)
        want = TUNED_SERVE_SPLIT["nsplit"] if which == "tuned" else 8
        if split.nsplit != want:
            fail(f"tune serve ({which}): the engine's decode takes {split}, "
                 f"not {want} splits")
        del engine
        if which == "tuned":
            os.remove(path)
    autotune.reset()
    same, first = _agreement(tokens["tuned"], tokens["rules"])
    say(f"tune serve: with the tuned cache file ({len(entries)} entries: a "
        f"{TUNED_SERVE_SPLIT['nsplit']}-way decode split, flash "
        f"{TUNED_SERVE_FLASH}) the greedy tokens equal the rules' for "
        f"{same} of {len(trace)} requests, first tokens {first} of "
        f"{len(trace)}")
    return {"requests": len(trace), "tokens_equal": same,
            "first_tokens_equal": first}


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
    # the run's own plan cache: no cache under the home directory changes
    # any run, and the tune phase writes only here
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                      "autotune.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    timer = Timer(torch)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(f"phase 3: {fn.__name__} in {time.perf_counter() - t0:.1f} s")
        return out

    results = {"int4_matmul_fused": timed(check_gemm, torch, timer)}
    gemm = results["int4_matmul_fused"]
    for key, label, shapes, rows, timed_rows, seed in (
            ("mamba_shapes", "mamba", MAMBA_GEMM_SHAPES, MAMBA_GEMM_ROWS,
             MAMBA_TIMED_ROWS, SEED + 30),
            ("hybrid_shapes", "recurrentgemma", HYBRID_GEMM_SHAPES,
             HYBRID_GEMM_ROWS, HYBRID_GEMM_ROWS, SEED + 31),
            *((f"{arch}_shapes", arch, shapes, HYBRID_GEMM_ROWS,
               HYBRID_GEMM_ROWS, SEED + 32 + i)
              for i, (arch, shapes) in enumerate(
                  DENSE_GEMM_SHAPES.items()))):
        t0 = time.perf_counter()
        gemm[key], err = check_gemm_at(torch, timer, label, shapes, rows,
                                       timed_rows, seed)
        gemm["max_abs_err"] = max(gemm["max_abs_err"], err)
        say(f"phase 3: check_gemm_at ({label}) in "
            f"{time.perf_counter() - t0:.1f} s")
    for name, check in (("flash_prefill", check_flash),
                        ("paged_decode_attention", check_decode),
                        ("ragged_decode_attention", check_ragged),
                        ("w4a16_matmul", check_w4a16)):
        results[name] = timed(check, torch, timer)
    results["lut4_matmul"], results["int4_matmul"] = timed(
        check_lut4_int4, torch, timer)
    results["lut_mul4"] = timed(check_mul4, torch, timer)
    del timer
    say(f"phase 3 (kernels): {time.perf_counter() - t_start:.1f} s after "
        "device checks")
    launches = phase_serve(torch)
    say(f"phase 4 (serve runs): {time.perf_counter() - t_start:.1f} s after "
        "device checks")
    entry = entry_points_run(torch)
    circuit = circuit_runs(torch, smi)
    launches = {k: launches[k] + entry[k] + circuit[k] for k in launches}
    say(f"phase 4 (serve): {time.perf_counter() - t_start:.1f} s after "
        "device checks")
    phase_cpu(torch)
    t0 = time.perf_counter()
    analysis_run()
    tune_runs(torch)
    tuned_serve_run(torch)
    say(f"phase 6 (analysis, tuning): {time.perf_counter() - t0:.1f} s")
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
