"""Continuous-batching serving driver for the PyTorch port.

Serves synthetic traffic (Poisson arrivals, or the mixed and bursty
scenarios) under a quantization plan (``--quant``, a uniform backend,
default W4A4-packed weights through the fused int4 GEMM; or
``--quant-plan``, a preset, JSON file or inline rules, which takes
precedence) and a paged KV pool (bf16, or int8/int4 with per-token scales)
with the prefix cache, and prints a JSON report with tokens/s and p50/p95
request latency.  ``--step bucketed`` runs flash prefill and fused paged
decode; ``--step ragged`` packs prefill chunks and decode tokens into one
ragged step a token budget wide.  Runs on ``cuda`` unless ``--device cpu``
is given; on ``cuda`` every step shape is captured in a CUDA graph and
replayed, and the report's ``recompiles_steady_state`` counts captures of a
shape seen before (0 in a sound run).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --step ragged --cache-dtype int8 --scenario mixed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --quant-plan "*=w4a16_packed/g128;lm_head=float"
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --requests 4 --prompt-lens 8,16 --gen-lens 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..configs import Runtime, ServingConfig, get_config
from ..kernels import ops
from ..serving.api import (bursty_trace, mixed_trace, poisson_trace,
                           run_trace)
from ..serving.engine import InferenceEngine, build_params

#: the bursty scenario's arrivals per burst and decode steps between bursts
#: (the reference CLI's defaults)
BURST, PERIOD = 4, 8


def serve(arch: str, *, reduced=True, layers=None, max_batch=4,
          page_size=16, num_pages=48, max_ctx=128, requests=8, rate=0.5,
          prompt_lens=(8, 16, 32), gen_lens=(8, 16), prefix_cache=True,
          scenario="poisson", step="bucketed",
          token_budget=0, cache_dtype="bfloat16", quant="w4a4_packed",
          quant_plan=None, seed=0, device="cuda"):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(**({"n_layers": layers} if layers else {}))
    elif layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rt = Runtime(attn_impl="flash", attn_chunk_q=min(512, max_ctx),
                 quant_backend=None if quant_plan else quant,
                 quant_plan=quant_plan, cache_dtype=cache_dtype)
    sv = ServingConfig(layout="paged", max_batch=max_batch,
                       page_size=page_size, num_pages=num_pages,
                       max_ctx=max_ctx, prefix_cache=prefix_cache, step=step,
                       token_budget=token_budget)
    if scenario == "mixed":
        trace = mixed_trace(requests, prompt_lens, gen_lens, cfg.vocab,
                            seed=seed)
    elif scenario == "bursty":
        trace = bursty_trace(requests, BURST, PERIOD, prompt_lens, gen_lens,
                             cfg.vocab, seed=seed)
    else:
        trace = poisson_trace(requests, rate, prompt_lens, gen_lens,
                              cfg.vocab, seed=seed)
    params = build_params(cfg, rt, seed, device)
    engine = InferenceEngine(cfg, rt, sv, params=params, device=device)
    engine.warmup(prompt_lens)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    ops.reset_launch_counts()
    stats, _ = run_trace(engine, trace)
    report = {"arch": arch, "reduced": reduced, "n_layers": cfg.n_layers,
              "quant": quant_plan or quant, "cache_dtype": cache_dtype,
              "step": step, "scenario": scenario,
              "device": str(engine.device),
              "device_name": (torch.cuda.get_device_name(engine.device)
                              if engine.device.type == "cuda" else "cpu"),
              "requests": requests, "rate_per_step": rate,
              "prefix_cache": bool(prefix_cache), "paged": stats,
              "kernel_launches": ops.launch_counts()}
    report["tokens_per_s"] = stats["decode_tok_per_s"]
    report["latency_p50_s"] = stats["latency_p50_s"]
    report["latency_p95_s"] = stats["latency_p95_s"]
    report["prefix_hit_rate"] = stats["prefix_hit_rate"]
    # captures of a step shape seen before (0 unless a step's shape key
    # drifts: see observability.jit_watch)
    report["recompiles_steady_state"] = stats["recompiles"]["steady_state"]
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--reduced", action="store_true", default=True)
    grp.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the layer count (depth cut)")
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
                    choices=["poisson", "mixed", "bursty"],
                    help="mixed: one arrival per step with cycling lengths; "
                         f"bursty: {BURST} arrivals every {PERIOD} steps")
    ap.add_argument("--step", default="bucketed",
                    choices=["bucketed", "ragged"],
                    help="bucketed prefill/decode steps, or the ragged "
                         "token-major step")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="ragged step's padded token capacity per step "
                         "(0 = auto from max_batch/page_size)")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args()

    out = serve(
        args.arch, reduced=args.reduced, layers=args.layers,
        max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages, max_ctx=args.max_ctx,
        requests=args.requests, rate=args.rate,
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        gen_lens=tuple(int(x) for x in args.gen_lens.split(",")),
        prefix_cache=args.prefix_cache == "on", scenario=args.scenario,
        step=args.step,
        token_budget=args.token_budget, cache_dtype=args.cache_dtype,
        quant=args.quant, quant_plan=args.quant_plan, seed=args.seed,
        device=args.device)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
