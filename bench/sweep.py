"""The knee of an open-loop cell, found once by a sweep on the card: one
engine, built and warmed once, serves the cell's traffic at each rate in
turn for a window, then drains.  For each rate it prints the requests due,
the first tokens served in the window, the waiting queue sampled each
second, and the time to first token at the 50th and 90th percentiles.
The knee is the highest rate at which every request due gets its first
token inside the window and the second half's time to first token is no
worse than the first half's: above it, arrivals outpace the serial
prefills and every later request waits longer.
Not part of a benchmark run.

    python3 bench/sweep.py --workload <cell> --rates 2,3,4,5 --seconds 30 \\
        [--seed 1] [--mix '{"prompt_tokens": {"min": 512, "max": 2048}}'] \\
        [--out sweep.jsonl]

Rates are requests a second, as the mix's ``rate_per_s``; `--mix` lays
keys over the cell's mix.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mix", default="{}")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import run as bench_run
    bench_run.set_env()
    import torch

    from harness import manifest, stats, traffic
    from harness.build import build_engine
    from harness.cell import Client

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfgfile = manifest.config(man, cell["config"])
    mix = {**manifest.traffic(cell["traffic"]), **json.loads(args.mix)}
    clock = time.perf_counter
    engine, api = build_engine(cfgfile, args.seed, clock, "cuda")
    rates = [float(r) for r in args.rates.split(",")]
    V = cfgfile["model"]["vocab_size"]
    lens = set()
    for i, r in enumerate(rates):
        lens |= set(traffic.prompt_lengths(traffic.generate(
            dict(mix, rate_per_s=r), args.seed + 1000 * i, V, args.seconds)))
    engine.warmup(sorted(lens))
    torch.cuda.synchronize()
    out = open(args.out, "a") if args.out else None
    for i, rate in enumerate(rates):
        # each rate draws prompts of its own: a prompt seen at an earlier
        # rate would hit the prefix cache
        items = traffic.generate(dict(mix, rate_per_s=rate),
                                 args.seed + 1000 * i, V, args.seconds)
        drv = Client(engine, api, items, clock,
                     lambda name: contextlib.nullcontext())
        t0 = clock()
        t_end = t0 + args.seconds
        queue, next_sample = [], t0
        while clock() < t_end:
            now = clock()
            if now >= next_sample:
                queue.append(len(engine.scheduler.waiting))
                next_sample += 1.0
            drv.submit_due(t0, now)
            if drv.idle:
                time.sleep(max(0.0, min(t0 + items[drv.next].due_s, t_end)
                               - clock()))
                continue
            drv.step(True, False)
        t_close = clock()
        due = [r for r in drv.recs[:drv.next] if r.due <= t_close]
        served = sum(1 for r in due if r.stamps and r.stamps[0] <= t_close)
        ttft = [(r.stamps[0] if r.stamps and r.stamps[0] <= t_close
                 else float("inf")) - r.due for r in due]
        tokens = sum(stats.tokens_in(r.stamps, t0, t_close)
                     for r in drv.recs)
        mid = t0 + (t_close - t0) / 2
        halves = [stats.percentile([x for r, x in zip(due, ttft)
                                    if (r.due < mid) == first], 90)
                  for first in (True, False)]
        line = {"workload": args.workload, "rate_per_s": rate,
                "prompt_tokens": mix["prompt_tokens"],
                "seconds": t_close - t0, "due": len(due),
                "first_tokens_in_window": served,
                "queue_each_s": queue,
                "ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
                "ttft_p90_ms": stats.percentile(ttft, 90) * 1e3,
                "ttft_p90_ms_by_half": [h * 1e3 if h is not None else None
                                        for h in halves],
                "output_tokens_per_s": tokens / (t_close - t0),
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        while not drv.idle:
            drv.step(False, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
