"""The benchmark's manifest and the files it names.

`BENCHMARK.json` sits at the root of the checkout.  Everything that belongs
to one configuration, traffic mix, per-layer metric or cell is a file of its
own, found by its name:

- ``bench/configs/<config>.json``: the configuration file (the cell's
  ``config`` names it through the manifest's ``configs[].file``);
- ``bench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader;
- ``bench/limits/<cell>.json``: the limits of the cell's comparison.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _read_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def as_run(cfgfile: Dict) -> Dict:
    """The model as the program runs it: the published keys (``model``)
    with the port's own departures from them (``departures``) laid over."""
    return {**cfgfile["model"], **cfgfile.get("departures", {})}


def traffic(name: str, bench: Path = BENCH) -> Dict:
    return _read_json(bench / "traffic" / f"{name}.json")


def limits(cell_name: str, bench: Path = BENCH) -> Dict:
    return _read_json(bench / "limits" / f"{cell_name}.json")


def reports(metric: Dict, cell_name: str) -> bool:
    """Whether `metric` is reported in `cell_name`: listed there, or listed
    nowhere."""
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def end_to_end(manifest: Dict, cell_name: str) -> List[Dict]:
    return [m for m in manifest["end_to_end"] if reports(m, cell_name)]


def per_layer(manifest: Dict, cell_name: str) -> List[Dict]:
    return [m for m in manifest["per_layer"] if reports(m, cell_name)]


def reader(metric_name: str, bench: Path = BENCH) -> Callable:
    """The `read(ctx)` function of ``bench/metrics/<metric_name>.py``."""
    path = bench / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
