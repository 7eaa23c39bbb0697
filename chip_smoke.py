"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. device   -- the card's name and power limit (nvidia-smi); refuses to
                 run without CUDA or outside a checkout of the repository.
  2. build    -- compiles every CUDA kernel under src/repro_torch/csrc, one
                 nvcc per source, all started together.
  3. kernels  -- each kernel against its plain PyTorch version on the same
                 inputs at the serving path's shapes: the W4A4 GEMM bit for
                 bit, the attention kernels within atol 2e-2 (bf16).  Times
                 (CUDA events, L2 flushed before each call) for the kernel,
                 the plain version and a PyTorch yardstick, beside the
                 least time the card could take (bytes over 3.35 TB/s or
                 operations over the int8/bf16 peak, whichever is larger).
  4. serve    -- full-width qwen2-0.5b (24 layers, random weights from a
                 seed, W4A4-packed projections, bf16 paged KV pool, flash
                 prefill, fused paged decode) serves a Poisson trace through
                 InferenceEngine on cuda.  Every request must finish ok with
                 tokens in [0, vocab), every parameter and cache tensor must
                 live on the card, and each kernel's launch count over the
                 run must be above zero.  Then a few decode steps at full
                 batch run under torch.profiler: step time, launches per
                 step, the card's busy share and the largest kernels.
  5. cpu      -- full width cut to 2 layers: one prefill and three decode
                 steps on cuda and on cpu with the same weights: float
                 weights in bf16 (logits within CPU_ATOL), the serving
                 path's W4A4 weights in float32 through the CUDA GEMM
                 (logits within CPU_W4A4_F32_ATOL), and the serving path
                 itself, W4A4 in bf16 (correlation reported, see
                 phase_cpu).

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

SEED = 0
#: ~2 ms of device time at H100 clocks: longer than the host needs to
#: enqueue any timed call
SLEEP_CYCLES = 4_000_000
MAX_BATCH = 8
PAGE_SIZE = 16
PROMPT_BUCKET = 256


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
    say(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
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


def check_gemm(torch, timer):
    from repro_torch.kernels.int4_matmul import (
        int4_matmul_fused_cuda, int4_matmul_fused_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bytes": 0.0, "ops": 0.0}
    worst = 0.0
    for M in (1, MAX_BATCH, PROMPT_BUCKET):
        for (K, N), per_layer in GEMM_SHAPES:
            x, w_q, w_km, w_scale = _gemm_inputs(torch, gen, M, K, N)
            got = int4_matmul_fused_cuda(x, w_km, w_scale)
            want = int4_matmul_fused_plain(x, w_km, w_scale)
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"int4_matmul_fused M={M} K={K} N={N}: kernel differs "
                     f"from the plain version (max |diff| {err})")
            n_bytes = M * K * 4 + w_km.numel() + N * 4 + M * N * 4
            n_ops = 2.0 * M * K * N
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
            t = timer.ms(lambda: int4_matmul_fused_cuda(x, w_km, w_scale))
            tp = timer.ms(lambda: int4_matmul_fused_plain(x, w_km, w_scale),
                          reps=5)
            lib = None
            if M > 16:
                a8 = torch.clamp(torch.round(x * 7.0 / x.abs().amax()), -8,
                                 7).to(torch.int8)
                lib = timer.ms(lambda: torch._int_mm(a8, w_q))
            say(f"gemm M={M:4d} K={K:5d} N={N:5d}: bit-exact; kernel "
                f"{t:.4f} ms, plain {tp:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), _int_mm {lib if lib is None else round(lib, 4)}")
            if M == PROMPT_BUCKET:
                total["ms"] += per_layer * t
                total["plain_ms"] += per_layer * tp
                total["bound_ms"] += per_layer * b_ms
                total["library_ms"] += per_layer * lib
                total["bytes"] += per_layer * n_bytes
                total["ops"] += per_layer * n_ops
    by = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
          >= total["ops"] / INT8_OPS_PER_S else "operations")
    return {"shape": f"one layer's 7 projections at M={PROMPT_BUCKET}",
            "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": by, "library_ms": total["library_ms"]}


def _decode_inputs(torch, gen, B, H, KV, hd, P, ps, pps, last_pos):
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k_pool = torch.randn((P, ps, KV, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    v_pool = torch.randn((P, ps, KV, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    tbl = torch.full((B, pps), P, dtype=torch.int32, device="cuda")
    used = 0
    for b, lp in enumerate(last_pos):
        n = -(-(lp + 1) // ps) if lp >= 0 else 0
        tbl[b, :n] = perm[used:used + n]       # beyond n: sentinel slots
        used += n
    lp = torch.tensor(last_pos, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, tbl, lp


def check_decode(torch, timer):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)
    from repro_torch.kernels.autotune import attn_default_blocks

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    H, KV, hd, ps = 14, 2, 64, PAGE_SIZE
    P, pps = 256, 512 // PAGE_SIZE
    # live contexts of a serving batch: two idle rows (-1), a page boundary
    last_pos = [287, 15, -1, 140, 16, 319, -1, 63]
    B = len(last_pos)
    q, k_pool, v_pool, tbl, lp = _decode_inputs(torch, gen, B, H, KV, hd, P,
                                                ps, pps, last_pos)
    pp = max(1, attn_default_blocks("attn.paged_decode", B, pps * ps, H * hd,
                                    group_size=ps)["bk"] // ps)
    got = paged_decode_attention_cuda(q, k_pool, v_pool, tbl, lp)
    want = paged_decode_attention_plain(q, k_pool, v_pool, tbl, lp, pp=pp)
    err = (got.float() - want.float()).abs().max().item()
    idle = [b for b, x in enumerate(last_pos) if x < 0]
    if err > ATTN_ATOL or not torch.all(got[idle] == 0):
        fail(f"paged_decode_attention: max |diff| {err} > {ATTN_ATOL} or an "
             "idle row is not zero")
    windowed = paged_decode_attention_cuda(q, k_pool, v_pool, tbl, lp,
                                           window=40)
    want_w = paged_decode_attention_plain(q, k_pool, v_pool, tbl, lp,
                                          window=40, pp=pp)
    err_w = (windowed.float() - want_w.float()).abs().max().item()
    if err_w > ATTN_ATOL:
        fail(f"paged_decode_attention window=40: max |diff| {err_w}")
    n_tok = sum(x + 1 for x in last_pos if x >= 0)
    n_bytes = (q.numel() * 2 * 2 + 2 * n_tok * KV * hd * 2 + tbl.numel() * 4
               + B * 4)
    n_ops = 4.0 * H * hd * n_tok
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    t = timer.ms(lambda: paged_decode_attention_cuda(q, k_pool, v_pool, tbl,
                                                     lp))
    tp = timer.ms(lambda: paged_decode_attention_plain(q, k_pool, v_pool, tbl,
                                                       lp, pp=pp), reps=5)
    F = torch.nn.functional
    G = H // KV
    S = pps * ps
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= lp[:, None])[:, None, None, :]

    def library():
        kf = k_pool[tbl.clamp(max=P - 1).long()].reshape(B, S, KV, hd)
        vf = v_pool[tbl.clamp(max=P - 1).long()].reshape(B, S, KV, hd)
        kf = kf.repeat_interleave(G, dim=2).transpose(1, 2)
        vf = vf.repeat_interleave(G, dim=2).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kf, vf,
                                              attn_mask=mask)

    lib = timer.ms(library)
    say(f"paged decode B={B} H={H} KV={KV} hd={hd} ps={ps}: max |diff| "
        f"{err:.3g} (window {err_w:.3g}); kernel {t:.4f} ms, plain "
        f"{tp:.4f} ms, bound {b_ms:.5f} ms ({b_by}), gather+SDPA {lib:.4f} ms")
    return {"shape": f"B={B}, H={H}, KV={KV}, hd={hd}, ps={ps}, "
                     f"{n_tok} live tokens",
            "max_abs_err": max(err, err_w), "ms": t, "plain_ms": tp,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def check_flash(torch, timer):
    from repro_torch.kernels.paged_attention import (
        flash_prefill_cuda, flash_prefill_plain)
    from repro_torch.kernels.autotune import attn_default_blocks

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    H, KV, hd = 14, 2, 64
    G = H // KV
    out = {}
    # fresh prefill: a 200-token prompt left-padded to the 256 bucket; tail
    # prefill: 64 suffix queries over a gathered 512-slot cache
    for case, Sq, Skv, n_real, hit in (("fresh", PROMPT_BUCKET, PROMPT_BUCKET,
                                        200, 0),
                                       ("tail", 64, 512, 50, 160)):
        q = torch.randn((1, Sq, H, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((1, Skv, KV, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((1, Skv, KV, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        base = torch.arange(Sq, device="cuda") - (Sq - n_real)
        qpos = torch.where(base >= 0, base + hit, -1).to(torch.int32)[None]
        if case == "fresh":
            kpos = qpos
        else:
            j = torch.arange(Skv, device="cuda")
            kpos = torch.where(j <= hit + n_real - 1, j, -1).to(
                torch.int32)[None]
        bk = attn_default_blocks("attn.prefill", Sq, Skv, H * hd)["bk"]
        got = flash_prefill_cuda(q, k, v, qpos, kpos)
        want = flash_prefill_plain(q, k, v, qpos, kpos, bk=bk)
        err = (got.float() - want.float()).abs().max().item()
        pad_rows = (qpos[0] < 0)
        if err > ATTN_ATOL or not torch.all(got[0, pad_rows] == 0):
            fail(f"flash_prefill ({case}): max |diff| {err} > {ATTN_ATOL} or "
                 "a padding row is not zero")
        got_w = flash_prefill_cuda(q, k, v, qpos, kpos, window=48)
        want_w = flash_prefill_plain(q, k, v, qpos, kpos, window=48, bk=bk)
        err_w = (got_w.float() - want_w.float()).abs().max().item()
        if err_w > ATTN_ATOL:
            fail(f"flash_prefill ({case}) window=48: max |diff| {err_w}")
        qp, kp = qpos[0].long(), kpos[0].long()
        pairs = int(((qp[:, None] >= kp[None, :]) & (kp[None, :] >= 0)
                     & (qp[:, None] >= 0)).sum().item())
        n_bytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + (Sq + Skv) * 4)
        n_ops = 4.0 * H * hd * pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timer.ms(lambda: flash_prefill_cuda(q, k, v, qpos, kpos))
        tp = timer.ms(lambda: flash_prefill_plain(q, k, v, qpos, kpos, bk=bk),
                      reps=5)
        F = torch.nn.functional
        allowed = ((qp[:, None] >= kp[None, :]) & (kp[None, :] >= 0))
        # padding queries see no key; give them one so SDPA stays finite
        allowed[:, 0] |= ~allowed.any(dim=1)
        mask = allowed[None, None]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        say(f"flash prefill {case} Sq={Sq} Skv={Skv} H={H} KV={KV} hd={hd}: "
            f"max |diff| {err:.3g} (window {err_w:.3g}); kernel {t:.4f} ms, "
            f"plain {tp:.4f} ms, bound {b_ms:.5f} ms ({b_by}), SDPA "
            f"{lib:.4f} ms")
        out[case] = {"shape": f"{case}: B=1, Sq={Sq}, Skv={Skv}, H={H}, "
                              f"KV={KV}, hd={hd}, {n_real} real queries",
                     "max_abs_err": max(err, err_w), "ms": t, "plain_ms": tp,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return out["fresh"]


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


def phase_serve(torch):
    from repro_torch.configs import Runtime, ServingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.api import poisson_trace, run_trace
    from repro_torch.serving.engine import InferenceEngine, build_params

    cfg = get_config("qwen2-0.5b")
    rt = Runtime(attn_impl="flash", quant_backend="w4a4_packed",
                 cache_dtype="bfloat16")
    sv = ServingConfig(layout="paged", max_batch=MAX_BATCH,
                       page_size=PAGE_SIZE, num_pages=320, max_ctx=512,
                       prefix_cache=True)
    t0 = time.perf_counter()
    params = build_params(cfg, rt, seed=SEED, device="cuda")
    engine = InferenceEngine(cfg, rt, sv, params=params, device="cuda")
    torch.cuda.synchronize()
    say(f"serve: built full-width {cfg.name} ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}) in "
        f"{time.perf_counter() - t0:.1f} s")
    for tree, what in ((engine.params, "parameter"), (engine.caches, "cache")):
        cpu = [t for t in _tensors(tree) if t.device.type != "cuda"]
        if cpu:
            fail(f"serve: {len(cpu)} {what} tensors are not on the card")
    prompt_lens, gen_lens = (32, 96, 160, 256), (16, 32, 64)
    trace = poisson_trace(8, 0.5, prompt_lens, gen_lens, cfg.vocab, seed=SEED)
    engine.warmup(prompt_lens)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats, finished = run_trace(engine, trace)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    bad = [r.rid for r in finished if r.outcome != "ok"]
    if len(finished) != len(trace) or bad:
        fail(f"serve: {len(finished)}/{len(trace)} requests retired, not ok: "
             f"{bad}")
    for r in finished:
        if len(r.tokens) != r.max_new or not all(
                0 <= t < cfg.vocab for t in r.tokens):
            fail(f"serve: request {r.rid} produced {len(r.tokens)} tokens "
                 f"(want {r.max_new}) or a token outside [0, {cfg.vocab})")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve: kernel {name} was never launched on the main path")
    say(f"serve: {len(finished)} requests ok, {stats['decode_tokens']} decode "
        f"tokens in {stats['wall_s']:.2f} s = {stats['decode_tok_per_s']:.1f} "
        f"tok/s; latency p50 {stats['latency_p50_s']:.3f} s, p95 "
        f"{stats['latency_p95_s']:.3f} s; ttft p50 {stats['ttft_p50_s']:.3f} s"
        f"; steps {stats['steps']}, preempted {stats['requests_preempted']}, "
        f"prefill tokens {stats['prefill_tokens']}")
    say(f"serve: kernel launches {json.dumps(launches)}")
    profile_decode(torch, engine, cfg.vocab)
    return launches, stats


def profile_decode(torch, engine, vocab: int, steps: int = 4):
    """Where a decode step's time goes: a full decode batch (MAX_BATCH
    requests of 200-token prompts) runs `steps` pure decode steps under
    torch.profiler.  Prints the step wall time, the device's busy share
    (kernel time over wall time), the launches per step and the kernels
    that take the most device time.  Runs after the serve phase has read
    its launch counts."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 3)
    for _ in range(MAX_BATCH):
        engine.submit(torch.randint(0, vocab, (200,), generator=gen).numpy(),
                      steps + 4)
    engine.step()                  # admit + prefill all, first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    say(f"profile: {steps} decode steps at batch {MAX_BATCH}: "
        f"{wall_us / steps / 1e3:.3f} ms per step, "
        f"{n_launch / steps:.0f} launches per step, device busy "
        + (f"{busy / wall_us:.3f} of wall time" if busy else "not measured "
           "(the profiler saw no device time)"))
    for e in kernels[:8]:
        say(f"profile:   {dev_us(e) / steps / 1e3:8.3f} ms/step "
            f"{e.count // steps:5d}x/step  {e.key[:90]}")


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


def phase_cpu(torch):
    """The card against the CPU path that the tests hold to the JAX
    package.  Three runs, each on both devices:

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
    )
    readings = {}
    for what, rt, atol in runs:
        logits, launches = _two_devices(torch, rt)
        a, b = logits["cuda"], logits["cpu"]
        diff = (a - b).abs()
        corr = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]
        relrms = (diff.square().mean() / b.square().mean()).sqrt().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        say(f"cpu: {what}, 2 layers at full width, prefill + 3 decode "
            f"steps: max |logit diff| {diff.max().item():.6g}, mean "
            f"{diff.mean().item():.6g}, rel rms {relrms:.6g}, corr "
            f"{corr.item():.6f} (|logit| <= {b.abs().max().item():.3f}), "
            f"argmax agreement {agree:.2f}, card launches "
            f"{json.dumps(launches)}")
        readings[what] = diff.max().item()
        if not torch.isfinite(a).all():
            fail(f"cpu: {what}: non-finite logits on the card")
        if rt.quant_backend == "w4a4_packed" \
                and launches["int4_matmul_fused"] <= 0:
            fail(f"cpu: {what}: the card's run never launched the W4A4 GEMM")
        if atol is not None and diff.max().item() > atol:
            fail(f"cpu: {what}: card and CPU logits differ by "
                 f"{diff.max().item():.6g} > {atol}")
        if atol is None and corr.item() < CPU_W4A4_CORR:
            fail(f"cpu: {what}: card and CPU logits correlate "
                 f"{corr.item():.4f} < {CPU_W4A4_CORR}")
    return readings


# --------------------------------------------------------------- main ----
SOURCES = {
    "int4_matmul_fused": ("src/repro_torch/csrc/int4_matmul.cu",
                          "src/repro/kernels/int4_matmul.py:138"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/paged_attention.py:384"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:157"),
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
               "paged_decode_attention": check_decode(torch, timer)}
    del timer
    launches, _ = phase_serve(torch)
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
