"""Continuous-batching serving driver for the PyTorch port.

Serves synthetic traffic (Poisson arrivals, or the shared_prefix, mixed
and bursty scenarios) under a quantization plan (``--quant``, a uniform backend,
default W4A4-packed weights through the fused int4 GEMM; or
``--quant-plan``, a preset, JSON file or inline rules, which takes
precedence) and a KV layout (``--layout paged``: a paged pool, bf16 or
int8/int4 with per-token scales, with the prefix cache; ``contiguous``: a
max_ctx cache row per batch slot; the default is paged for attention
stacks and contiguous for the others: mamba2-130m and the hybrid
recurrentgemma-9b, whose prompts prefill at exact length), and prints a
JSON report with tokens/s and p50/p95 request latency.  ``--step
bucketed`` runs flash prefill and fused paged decode (contiguous: exact
attention over the row); ``--step ragged`` (paged) packs prefill chunks
and decode tokens into one ragged step a token budget wide.

``--layout compare`` is the bit-identity harness: the same trace through
five attention paths, ``paged`` (fused paged decode), ``paged_gather``
(the gather-then-attend baseline), ``contiguous``, ``paged_nocache`` (the
prefix cache off; with the prefix cache on) and ``ragged``, with
exact-softmax prefill (``attn_impl="chunked"``), and ``bit_identical``
in the report; tokens that differ between paths exit with a failure,
unless a lossy KV dtype explains it, as the JAX package's CLI rules.

Runs on ``cuda`` unless ``--device cpu`` is given; on ``cuda`` every step
shape is captured in a CUDA graph and replayed, and the report's
``recompiles_steady_state`` counts captures of a shape seen before (0 in
a sound run).  The report carries the engine's
`profile()` (one decode step's time against its decode attention alone).

``--sweep`` adds the per-site quantization sensitivity table
(``launch.sensitivity``) to the report.

``--quantized-ckpt`` serves from a quantized checkpoint
(`quantized_ckpt_report`): fresh f32 masters are packed and saved under
the plan (``checkpoint.save_quantized``: uint8 nibbles, bf16 scales, the
plan in the manifest), restored with no float master and the plan checked
(``restore_quantized``), and saved as float masters beside it for the
size; the report's ``quantized_ckpt`` holds ``bit_identical_logits`` (the
restored tree's forward against the plan packed from the masters in
memory), ``quantized_bytes``, ``float_master_bytes``, ``save_s``,
``load_s`` and ``tokens_match`` (the trace served from the restored tree
against the same trace served from the in-memory pack).  ``--ckpt-dir``
keeps the checkpoints (default: a temporary directory).

``--scenario shared_prefix`` gives every prompt one shared system prefix
(``--sys-len`` tokens) and a user suffix from ``--prompt-lens``: the
report's ``prefix_hit_rate`` and ``tokens_prefilled_saved`` show the
prefix cache at work.  ``--scenario chaos`` (or ``cancel_storm``, a
cancel-only preset) runs the seeded fault-injection harness
(``serving.chaos``: cancels, deadlines, allocator failures, step faults,
a snapshot/restore) in both step modes against one fault-free bucketed
reference, with exact-softmax prefill (``attn_impl="chunked"``) as the
JAX package's CLI does.  ``--max-queue`` bounds the admission queue (the
chaos scenarios default to twice the batch), ``--trace-out`` writes the
run's Chrome/Perfetto timeline, ``--metrics off`` disables the registry
and the recompile sentinel.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --step ragged --cache-dtype int8 --scenario mixed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --quant-plan "*=w4a16_packed/g128;lm_head=float"
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --requests 4 --prompt-lens 8,16 --gen-lens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --scenario shared_prefix --sys-len 32 \
        --trace-out /tmp/serve_trace.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --scenario chaos --chaos-seed 3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --layout compare
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --layers 2 --quant-plan mixed_sensitive \
        --quantized-ckpt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --full --max-ctx 512 --max-batch 8 \
        --num-pages 320 --prompt-lens 32,96,160,256 --gen-lens 16,32,64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
        --full --layers 4 --max-ctx 512 --max-batch 8 --num-pages 320

The MoE configs (arctic-480b, llama4-maverick-400b-a17b) serve with every
expert on the one device, so at full width only a few layers fit the
card (``--layers``); the build packs a layer at a time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from ..configs import Runtime, ServingConfig, get_config
from ..kernels import ops
from ..observability import Telemetry
from ..serving.api import (bursty_trace, mixed_trace, poisson_trace,
                           run_trace, shared_prefix_trace)
from ..serving.engine import InferenceEngine, build_params

#: the five attention paths of ``--layout compare`` (``paged_nocache`` only
#: with the prefix cache on)
COMPARE_PATHS = ("paged", "paged_gather", "contiguous", "paged_nocache",
                 "ragged")


def compare_path(path: str, rt, sv):
    """The Runtime and ServingConfig of compare path `path` over the run's
    `rt` and a bucketed paged `sv`: its layout, its step, the gather
    baseline for ``paged_gather``, the prefix cache off for
    ``paged_nocache``."""
    if path == "paged_gather":
        rt = dataclasses.replace(rt, paged_attn="gather")
    return rt, dataclasses.replace(
        sv, layout="contiguous" if path == "contiguous" else "paged",
        step="ragged" if path == "ragged" else "bucketed",
        prefix_cache=sv.prefix_cache and path != "paged_nocache")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def quantized_ckpt_report(cfg, rt, ckpt_dir: str, masters, seed: int = 0):
    """Save a quantized checkpoint of the f32 `masters` under the active
    plan into ``<ckpt_dir>/q``, restore it on the masters' device (plan
    checked; the kernels' twins rebuilt on CUDA) and save the masters as a
    float checkpoint into ``<ckpt_dir>/f``; then run one forward of the
    restored tree and of the plan packed from the masters in memory on a
    seeded 8-token prompt.  Returns (the restored tree, the in-memory
    pack, the report)."""
    from ..checkpoint import (restore_quantized, save_checkpoint,
                              save_quantized)
    from ..core.qlinear import prepack_tree
    from ..core.quant_plan import CKPT_PACKED, active_plan, plan_pack_tree
    from ..models.transformer import forward

    dev = masters["embed"]["tok"].device

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    plan = active_plan(cfg, rt)
    qdir, fdir = os.path.join(ckpt_dir, "q"), os.path.join(ckpt_dir, "f")
    t0 = clock()
    save_quantized(qdir, 0, masters, cfg, plan=plan)
    save_s = clock() - t0
    t0 = clock()
    restored, manifest = restore_quantized(qdir, cfg=cfg, rt=rt, device=dev)
    load_s = clock() - t0
    t0 = clock()
    save_checkpoint(fdir, 0, masters)
    float_save_s = clock() - t0
    reference = plan_pack_tree(masters, cfg, plan, backends=CKPT_PACKED,
                               scale_dtype=torch.bfloat16)
    if dev.type == "cuda":
        reference = prepack_tree(reference)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (1, 8), generator=gen,
                           dtype=torch.int32).to(dev)
    with torch.inference_mode():
        la = forward(restored, tokens, cfg, rt)[0]
        lb = forward(reference, tokens, cfg, rt)[0]
    report = {
        "plan": plan.name or "inline",
        "manifest_format": manifest.get("format"),
        "bit_identical_logits": bool(torch.equal(la, lb)),
        "quantized_bytes": _dir_bytes(qdir),
        "float_master_bytes": _dir_bytes(fdir),
        "save_s": save_s,
        "load_s": load_s,
        "float_save_s": float_save_s,
    }
    return restored, reference, report


def model_config(arch: str, reduced: bool = True, layers=None):
    """The arch's config (reduced or full width) at its own depth or at
    `layers`, which must be a whole number of repeat units plus the tail:
    recurrentgemma-9b stacks (R, R, A) units and an (R, R) tail, so its
    depths are 2 + 3k."""
    cfg = get_config(arch)
    if layers:
        P, T = len(cfg.pattern), len(cfg.tail)
        if layers < P + T or (layers - T) % P:
            raise ValueError(
                f"--layers {layers}: {arch} stacks units of {P} blocks "
                f"{cfg.pattern} and then a tail of {T} {cfg.tail}, so its "
                f"depth is {T} + {P} * k with k >= 1")
    if reduced:
        return cfg.reduced(**({"n_layers": layers} if layers else {}))
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def serve(arch: str, *, reduced=True, layers=None, layout=None, max_batch=4,
          page_size=16, num_pages=48, max_ctx=128, requests=8, rate=0.5,
          prompt_lens=(8, 16, 32), gen_lens=(8, 16), prefix_cache=True,
          scenario="poisson", sys_len=32, step="bucketed",
          token_budget=0, burst=4, period=8, cache_dtype="bfloat16",
          quant="w4a4_packed",
          quant_plan=None, seed=0, chaos_seed=0, max_queue=0,
          trace_out=None, metrics=True, sweep=False, quantized_ckpt=False,
          ckpt_dir=None, device="cuda"):
    cfg = model_config(arch, reduced, layers)
    if scenario in ("chaos", "cancel_storm"):
        # the seeded fault-injection harness in both step modes against one
        # fault-free bucketed reference, with exact-softmax prefill
        # ("chunked") so that the bucketed and ragged survivors compare the
        # same arithmetic
        from ..serving.chaos import CANCEL_STORM, ChaosConfig, chaos_report

        rt = Runtime(attn_impl="chunked", attn_chunk_q=min(512, max_ctx),
                     quant_backend=None if quant_plan else quant,
                     quant_plan=quant_plan, cache_dtype=cache_dtype)
        base = CANCEL_STORM if scenario == "cancel_storm" else ChaosConfig()
        chaos = dataclasses.replace(
            base, seed=chaos_seed, n_requests=requests, rate_per_step=rate,
            prompt_lens=tuple(prompt_lens), gen_lens=tuple(gen_lens),
            stop_resume_at=(max(2, requests // 2),))
        # the chaos runs always bound the admission queue, so shedding runs
        # (deterministically: the queue's depth at submit follows the seed)
        sv = ServingConfig(layout="paged", max_batch=max_batch,
                           page_size=page_size, num_pages=num_pages,
                           max_ctx=max_ctx, prefix_cache=prefix_cache,
                           token_budget=token_budget,
                           max_queue=max_queue or 2 * max_batch)
        return {"arch": arch, "reduced": reduced, "scenario": scenario,
                "quant": quant_plan or quant, "cache_dtype": cache_dtype,
                "device": device,
                **chaos_report(cfg, rt, sv, chaos, device=device)}
    if layout is None:   # an SSM state does not page
        blocks = tuple(cfg.pattern) + tuple(cfg.tail)
        layout = "paged" if all(bt == "A" for bt in blocks) else "contiguous"
    # perf runs prefill through the flash kernel; the compare harness runs
    # exact-softmax prefill ("chunked") so that its token identity compares
    # the same arithmetic (flash's online softmax rounds otherwise, and on
    # random weights that can flip an argmax tie in the prompt logits)
    rt = Runtime(attn_impl="chunked" if layout == "compare" else "flash",
                 attn_chunk_q=min(512, max_ctx),
                 quant_backend=None if quant_plan else quant,
                 quant_plan=quant_plan, cache_dtype=cache_dtype)
    warm_lens = tuple(prompt_lens)
    if scenario == "shared_prefix":
        trace = shared_prefix_trace(requests, rate, sys_len, prompt_lens,
                                    gen_lens, cfg.vocab, seed=seed)
        # the cold full prompts (system prefix + user suffix) and the tail
        # buckets a prefix hit leaves behind
        warm_lens = tuple(prompt_lens) + tuple(sys_len + p
                                               for p in prompt_lens)
    elif scenario == "mixed":
        trace = mixed_trace(requests, prompt_lens, gen_lens, cfg.vocab,
                            seed=seed)
    elif scenario == "bursty":
        trace = bursty_trace(requests, burst, period, prompt_lens, gen_lens,
                             cfg.vocab, seed=seed)
    else:
        trace = poisson_trace(requests, rate, prompt_lens, gen_lens,
                              cfg.vocab, seed=seed)
    paths = ([p for p in COMPARE_PATHS
              if prefix_cache or p != "paged_nocache"]
             if layout == "compare" else [layout])
    report = {"arch": arch, "reduced": reduced, "n_layers": cfg.n_layers,
              "layout": layout, "quant": quant_plan or quant,
              "cache_dtype": cache_dtype, "step": step, "scenario": scenario,
              "requests": requests, "rate_per_step": rate,
              "prefix_cache": bool(prefix_cache),
              **({"sys_len": sys_len} if scenario == "shared_prefix"
                 else {})}
    params_ref = None
    if quantized_ckpt:
        # serve from the restored checkpoint; the in-memory pack serves the
        # trace again afterwards, and the tokens must match
        from ..models.transformer import init_model
        from ..serving.engine import resolve_device

        dev = resolve_device(device)
        masters = init_model(torch.Generator(device=dev).manual_seed(seed),
                             cfg)

        def with_dir(d):
            return quantized_ckpt_report(cfg, rt, d, masters, seed)

        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            params, params_ref, report["quantized_ckpt"] = with_dir(ckpt_dir)
        else:
            with tempfile.TemporaryDirectory() as d:
                params, params_ref, report["quantized_ckpt"] = with_dir(d)
        del masters
    else:
        params = build_params(cfg, rt, seed, device)
    tokens_by_path, launches = {}, {}
    sv = ServingConfig(layout="paged" if layout == "compare" else layout,
                       max_batch=max_batch, page_size=page_size,
                       num_pages=num_pages, max_ctx=max_ctx,
                       step=step if layout == "paged" else "bucketed",
                       token_budget=token_budget, max_queue=max_queue,
                       prefix_cache=prefix_cache)
    for path in paths:
        rt_path, sv_path = (compare_path(path, rt, sv) if layout == "compare"
                            else (rt, sv))
        # one registry per engine; the timeline records the first path
        tm = Telemetry(metrics=metrics,
                       trace=bool(trace_out) and path == paths[0])
        engine = InferenceEngine(cfg, rt_path, sv_path, params=params,
                                 device=device, telemetry=tm)
        engine.warmup(warm_lens)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        ops.reset_launch_counts()
        stats, finished = run_trace(engine, trace)
        stats["kernel_launches"] = ops.launch_counts()
        for name, n in stats["kernel_launches"].items():
            launches[name] = launches.get(name, 0) + n
        # attention vs GEMM attribution of one decode step, stamped with
        # the step it was taken at
        stats["profile"] = engine.profile()
        stats["profile_at_step"] = stats["profile"]["at_step"]
        report[path] = stats
        tokens_by_path[path] = [r.tokens for r in finished]
        if tm.trace.enabled:
            tm.trace.save(trace_out)
            report["trace_out"] = trace_out
    if params_ref is not None:
        rt_ref, sv_ref = (compare_path(paths[0], rt, sv)
                          if layout == "compare" else (rt, sv))
        engine_ref = InferenceEngine(cfg, rt_ref, sv_ref, params=params_ref,
                                     device=device)
        engine_ref.warmup(warm_lens)
        _, finished_ref = run_trace(engine_ref, trace)
        report["quantized_ckpt"]["tokens_match"] = (
            tokens_by_path[paths[0]] == [r.tokens for r in finished_ref])
    report["device"] = str(engine.device)
    report["device_name"] = (torch.cuda.get_device_name(engine.device)
                             if engine.device.type == "cuda" else "cpu")
    report["kernel_launches"] = launches
    if layout == "compare":
        _compare_report(report, paths, tokens_by_path, cache_dtype)
    stats = report[paths[0]]
    report["tokens_per_s"] = stats["decode_tok_per_s"]
    report["latency_p50_s"] = stats["latency_p50_s"]
    report["latency_p95_s"] = stats["latency_p95_s"]
    report["prefix_hit_rate"] = stats["prefix_hit_rate"]
    report["tokens_prefilled_saved"] = stats["tokens_prefilled_saved"]
    # captures of a step shape seen before (0 unless a step's shape key
    # drifts: see observability.jit_watch); compare mode takes the largest
    # over its engines, so one path recapturing fails the gate
    report["recompiles_steady_state"] = max(
        report[p]["recompiles"].get("steady_state", 0) for p in paths)
    if sweep:
        from .sensitivity import sensitivity_sweep

        report["sensitivity"] = sensitivity_sweep(cfg, seed=seed,
                                                  device=device)
    return report


def _compare_report(report, paths, tokens_by_path, cache_dtype) -> None:
    """`report["bit_identical"]`: every path's tokens equal the first's.
    Where they differ, only the paged paths preempt and take prefix-cache
    hits, and the ragged path always prefills over its (dequantized) pool:
    with a lossy KV dtype that is expected and noted; otherwise the run
    fails, as the JAX package's CLI rules."""
    ref = tokens_by_path[paths[0]]
    diverged = [p for p in paths[1:] if tokens_by_path[p] != ref]
    report["bit_identical"] = not diverged
    if not diverged:
        return
    lossy_paths = (report["paged"]["requests_preempted"] > 0
                   or report["paged"]["tokens_prefilled_saved"] > 0
                   or "ragged" in diverged)
    if cache_dtype in ("int8", "int4") and lossy_paths:
        report["note"] = ("paged/ragged diverged after preemption, a "
                          "prefix-cache hit, or a chunked prefill with a "
                          "lossy KV-cache dtype: the other path attends "
                          "those prefixes in full precision — expected")
    else:
        raise SystemExit(f"FAIL: decode diverged across attention paths "
                         f"({paths[0]} vs {diverged})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--reduced", action="store_true", default=True)
    grp.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the layer count (depth cut)")
    ap.add_argument("--layout", default=None,
                    choices=["paged", "contiguous", "compare"],
                    help="KV layout (default: paged for attention stacks, "
                         "else contiguous); compare serves the trace through "
                         "the five attention paths and checks their tokens")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=48)
    ap.add_argument("--max-ctx", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate in requests per decode step")
    ap.add_argument("--prompt-lens", default="8,16,32")
    ap.add_argument("--gen-lens", default="8,16")
    ap.add_argument("--scenario", default="poisson",
                    choices=["poisson", "shared_prefix", "mixed", "bursty",
                             "chaos", "cancel_storm"],
                    help="shared_prefix: one shared system prefix "
                         "(--sys-len) + a user suffix from --prompt-lens; "
                         "mixed: one arrival per step with cycling lengths; "
                         "bursty: --burst arrivals every --period steps; "
                         "chaos: the seeded fault-injection harness "
                         "(cancels, deadlines, allocator failures, step "
                         "faults, stop/resume) in both step modes, "
                         "survivors held to a fault-free run; cancel_storm: "
                         "its cancel-only preset")
    ap.add_argument("--sys-len", type=int, default=32,
                    help="shared system-prompt length (shared_prefix)")
    ap.add_argument("--step", default="bucketed",
                    choices=["bucketed", "ragged"],
                    help="bucketed prefill/decode steps, or the ragged "
                         "token-major step")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="ragged step's padded token capacity per step "
                         "(0 = auto from max_batch/page_size)")
    ap.add_argument("--burst", type=int, default=4,
                    help="arrivals per burst (bursty scenario)")
    ap.add_argument("--period", type=int, default=8,
                    help="steps between bursts (bursty scenario)")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"])
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=["bfloat16", "int8", "int4"],
                    help="KV pool: bf16, or int8/int4 with per-token scales")
    ap.add_argument("--quant", default="w4a4_packed",
                    help="uniform backend for every projection (lm_head "
                         "stays float): w4a4_packed, w4a16_packed, int_sim, "
                         "lut4, w4a16, fake_quant or float")
    ap.add_argument("--quant-plan", default=None,
                    help="quantization plan, taking precedence over --quant: "
                         "a preset name, a JSON path, or inline "
                         "pattern=backend[/g<G>][;...] rules")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos scenarios' trace and fault "
                         "stream (--seed picks the weights)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: submissions past this "
                         "many waiting requests are shed (0 = unbounded; "
                         "the chaos scenarios default to 2 * max_batch)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's Chrome/Perfetto trace_event JSON "
                         "timeline here")
    ap.add_argument("--metrics", default="on", choices=["on", "off"],
                    help="telemetry registry and recompile sentinel (off: "
                         "stats() reports empty metrics and recompiles)")
    ap.add_argument("--sweep", action="store_true",
                    help="add the per-site sensitivity table to the report")
    ap.add_argument("--quantized-ckpt", action="store_true",
                    help="serve from a quantized checkpoint (save, restore, "
                         "check its logits bit-identical to the plan packed "
                         "from the float masters)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep the quantized checkpoint here (default: a "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)
    try:
        model_config(args.arch, args.reduced, args.layers)
    except (KeyError, ValueError) as e:
        ap.error(str(e))

    out = serve(
        args.arch, reduced=args.reduced, layers=args.layers,
        layout=args.layout, max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages, max_ctx=args.max_ctx,
        requests=args.requests, rate=args.rate,
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        gen_lens=tuple(int(x) for x in args.gen_lens.split(",")),
        prefix_cache=args.prefix_cache == "on", scenario=args.scenario,
        sys_len=args.sys_len, step=args.step,
        token_budget=args.token_budget, burst=args.burst,
        period=args.period, cache_dtype=args.cache_dtype,
        quant=args.quant, quant_plan=args.quant_plan, seed=args.seed,
        chaos_seed=args.chaos_seed, max_queue=args.max_queue,
        trace_out=args.trace_out, metrics=args.metrics == "on",
        sweep=args.sweep, quantized_ckpt=args.quantized_ckpt,
        ckpt_dir=args.ckpt_dir, device=args.device)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
