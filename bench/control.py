"""The comparison's readings for setting its limits, on the card: for each
seed, one run of the cell at its own load, then the program's readings and
the control's (the reference in fp8 in the program's place).  With
``--fault``, the timed path is broken underneath (`FAULTS`); with
``--cache-dtype int8``, the program runs its own lower path, an int8 KV
pool.  Not part of a benchmark run.

    python3 bench/control.py --workload <cell> --seconds 15 --seeds 1,2,3 \\
        [--fault tokens|decode_page|prefill_page|prefill_scale] \\
        [--cache-dtype int8] [--out control.jsonl]
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def alter_tokens(engine, patch=setattr) -> None:
    """Every token the engine produces, prefill's and decode's, moved to
    another id where it is produced: the fault a token check must see."""
    vocab = engine.cfg.vocab

    class Altered:
        def __init__(self, fn):
            self.fn = fn

        def __call__(self, *args):
            nxt, caches = self.fn(*args)
            return (nxt + 7) % vocab, caches

        def __getattr__(self, key):
            return getattr(self.fn, key)

    for name in ("_prefill", "_prefill_tail", "_decode"):
        patch(engine, name, Altered(getattr(engine, name)))


def drop_decode_page(engine, patch=setattr) -> None:
    """Paged decode reads every row's context but its newest page's worth
    of keys: a split or a length off by a page."""
    import torch
    from repro_torch.kernels import ops

    ps = engine.sv.page_size
    inner = ops.paged_decode_attention

    def paged_decode_attention(q, k_pool, v_pool, tbl, last_pos, *a, **kw):
        short = torch.where(last_pos >= ps, last_pos - ps, last_pos)
        return inner(q, k_pool, v_pool, tbl, short, *a, **kw)

    patch(ops, "paged_decode_attention", paged_decode_attention)


def drop_prefill_page(engine, patch=setattr) -> None:
    """Flash prefill leaves out the keys of the prompt's last page."""
    import torch
    from repro_torch.kernels import ops

    ps = engine.sv.page_size
    inner = ops.flash_prefill

    def flash_prefill(q, k, v, q_positions, k_positions, **kw):
        last = k_positions.max(dim=1, keepdim=True).values
        k_positions = torch.where(k_positions > last - ps, -1, k_positions)
        return inner(q, k, v, q_positions, k_positions, **kw)

    patch(ops, "flash_prefill", flash_prefill)


def scale_prefill_softmax(engine, patch=setattr) -> None:
    """Flash prefill's softmax at half its scale (the scores of a head
    dimension twice the model's)."""
    from repro_torch.kernels import ops

    inner = ops.flash_prefill

    def flash_prefill(q, *args, **kw):
        return inner(q * 0.5, *args, **kw)

    patch(ops, "flash_prefill", flash_prefill)


FAULTS = {"tokens": alter_tokens, "decode_page": drop_decode_page,
          "prefill_page": drop_prefill_page,
          "prefill_scale": scale_prefill_softmax}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--cache-dtype", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import run as bench_run
    bench_run.set_env()
    import torch

    from harness import cell, manifest

    man = manifest.load(ROOT)
    spec = manifest.cell(man, args.workload)
    cfgfile = manifest.config(man, spec["config"])
    if args.cache_dtype:
        cfgfile["serving"]["cache_dtype"] = args.cache_dtype
    out = open(args.out, "a") if args.out else None
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore():
        while undo:
            obj, name, old = undo.pop()
            setattr(obj, name, old)

    fault = ((lambda engine: FAULTS[args.fault](engine, patch))
             if args.fault else None)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = cell.execute(spec, cfgfile, manifest.traffic(spec["traffic"]),
                           manifest.limits(args.workload),
                           manifest.end_to_end(man, args.workload), seed,
                           args.seconds, False, "cuda", t,
                           fault=fault,
                           controls=(torch.float8_e4m3fn,))
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "cache_dtype": args.cache_dtype,
                "correct": res["correct"],
                "readings": res["readings"], "controls": res["controls"],
                "metrics": res["metrics"], "device": res["device"],
                "attempted": res["attempted"], "failed": res["failed"],
                "check": res["check"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        restore()
        # the engine holds cycles: collect it before the next one is built
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
