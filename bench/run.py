"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``src/repro_torch``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace
1`` ``breakdown``), and last ``check``: each number the comparison read,
beside its limit.  The same numbers are the last lines of standard error.
Exits with another code than 0, printing no result, when the card, the
port or the manifest is missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in the run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the tuner's cache file the run points the port at: it must not exist, so
#: every launch takes its rule's plan and nothing from HOME leaks in
NO_TUNED_PLANS = BENCH / "no-tuned-plans.json"


def fail(msg: str, code: int = 2) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return code


def set_env() -> None:
    """Every cache of the program at a fixed path inside the checkout."""
    cache = BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(NO_TUNED_PLANS)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no port at {ROOT / 'src' / 'repro_torch'}")
    if not (ROOT / "BENCHMARK.json").is_file():
        return fail("no BENCHMARK.json at the checkout's root")
    if NO_TUNED_PLANS.exists():
        return fail(f"{NO_TUNED_PLANS} exists: remove it, the benchmark "
                    "runs the plans' rules")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    set_env()
    import torch

    from harness import cell, manifest

    man = manifest.load(ROOT)
    try:
        chips = manifest.cell(man, args.workload)["chips"]
    except KeyError as exc:
        return fail(str(exc))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA device(s); "
                    f"{torch.cuda.device_count()} available")
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      man=man)
    bad = loaded_forbidden()
    if bad:
        return fail(f"modules loaded in the run's process: {bad}", 3)
    print(f"card {card_line()}")
    checks = result.pop("check")
    for name, row in checks.items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    result["check"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
