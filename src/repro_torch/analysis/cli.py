"""Command-line entry point: ``python -m repro_torch.analysis``."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.core import (
    Finding,
    all_rules,
    analyze_paths,
    gate,
    load_baseline,
    write_baseline,
)

#: the port's own files: its package, the tests (both packages' tests sit in
#: one folder), the card's smoke run and the kernel ablation scripts
DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py",
                 "decode_ablation.py", "flash_ablation.py",
                 "lut4_ablation.py", "w4a16_ablation.py",
                 "w4a4_ablation.py")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract-aware static analysis for the PyTorch port "
                    "(capture/host-sync/kernel-wrapper/bit-identity "
                    "invariants).")
    p.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                   help="files or directories to analyze "
                        "(default: the port's files, DEFAULT_PATHS)")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help="committed baseline; only findings NOT in it fail")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into --baseline "
                        "(preserving existing justifications) and exit 0")
    p.add_argument("--rules", metavar="R1,R2", default=None,
                   help="run only these rules")
    p.add_argument("--list-rules", action="store_true")
    return p


def _select_rules(spec: Optional[str]):
    rules = all_rules()
    if spec is None:
        return rules
    wanted = [r.strip() for r in spec.split(",") if r.strip()]
    unknown = [r for r in wanted if r not in rules]
    if unknown:
        raise SystemExit(f"unknown rule(s): {', '.join(unknown)} "
                         f"(see --list-rules)")
    return {name: rules[name] for name in wanted}


def _report_json(findings: List[Finding], new: List[Finding],
                 known: List[Finding], stale: List[str]) -> str:
    return json.dumps({
        "version": 1,
        "counts": {"total": len(findings), "new": len(new),
                   "baselined": len(known), "stale_baseline": len(stale)},
        "findings": [f.to_dict() for f in findings],
        "new": [f.fingerprint for f in new],
        "stale_baseline": stale,
    }, indent=1, sort_keys=True)


def _report_human(findings: List[Finding], new: List[Finding],
                  known: List[Finding], stale: List[str],
                  baselined: bool) -> str:
    lines: List[str] = []
    for f in (new if baselined else findings):
        lines.append(f"{f.location()}: [{f.rule}] {f.message}")
    if baselined and known:
        lines.append(f"  ({len(known)} baselined finding(s) suppressed; "
                     f"see the baseline file for justifications)")
    for fp in stale:
        lines.append(f"  stale baseline entry (violation fixed — prune "
                     f"with --write-baseline): {fp}")
    bad = new if baselined else findings
    lines.append(f"{len(bad)} new finding(s), {len(findings)} total.")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = _select_rules(args.rules)
    if args.list_rules:
        for r in rules.values():
            print(f"{r.name}: {r.summary}")
        return 0

    findings = analyze_paths(args.paths, rules=rules)

    baseline: Dict[str, Dict[str, str]] = {}
    if args.baseline:
        baseline = load_baseline(args.baseline)
    new, known, stale = gate(findings, baseline)

    if args.write_baseline:
        if not args.baseline:
            print("--write-baseline requires --baseline FILE",
                  file=sys.stderr)
            return 2
        write_baseline(args.baseline, findings, old=baseline)
        print(f"wrote {len(findings)} entr(ies) to {args.baseline}")
        return 0

    if args.format == "json":
        print(_report_json(findings, new, known, stale))
    else:
        print(_report_human(findings, new, known, stale,
                            baselined=bool(args.baseline)))

    return 1 if new else 0
