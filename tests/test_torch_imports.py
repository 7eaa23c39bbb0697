"""The PyTorch port stands alone: importing every module of repro_torch
pulls in neither JAX nor any module of the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    # the slice's modules, mirroring the reference's paths
    for name in ("repro_torch.kernels.paged_attention",
                 "repro_torch.kernels.int4_matmul",
                 "repro_torch.kernels.w4a16_matmul",
                 "repro_torch.kernels.lut4_matmul",
                 "repro_torch.kernels.lut_mul4",
                 "repro_torch.kernels.ref",
                 "repro_torch.core.backends",
                 "repro_torch.core.quant_plan",
                 "repro_torch.serving.engine",
                 "repro_torch.launch.steps",
                 "repro_torch.observability.jit_watch",
                 "repro_torch.observability.trace",
                 "repro_torch.distributed.fault_tolerance",
                 "repro_torch.serving.chaos",
                 "repro_torch.serving.api",
                 "repro_torch.launch.serve",
                 "repro_torch.core.netlist",
                 "repro_torch.core.mult4_proposed",
                 "repro_torch.core.mult4_baselines",
                 "repro_torch.core.timing",
                 "repro_torch.core.area",
                 "repro_torch.core.pipeline_mult",
                 "repro_torch.launch.sensitivity"):
        assert name in report["modules"]


def _import_roots(script: str):
    """The root package of every import statement of `script`, at any
    depth."""
    import ast

    tree = ast.parse((SRC.parent / script).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """Every import statement of chip_smoke.py, at any depth, names torch,
    the port or the standard library: never jax or the JAX package."""
    roots = _import_roots("chip_smoke.py")
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_quickstart_imports_neither_jax_nor_the_reference():
    """The same for the port's quickstart, examples/quickstart_torch.py."""
    roots = _import_roots("examples/quickstart_torch.py")
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


@pytest.mark.parametrize("script", ["w4a4_ablation.py", "lut4_ablation.py",
                                    "w4a16_ablation.py", "flash_ablation.py",
                                    "decode_ablation.py"])
def test_ablation_scripts_import_neither_jax_nor_the_reference(script):
    """The chip-side ablation scripts, their timing programs (run from a
    string in a child process) included, import torch, the port and
    chip_smoke, never jax or the JAX package."""
    import ast
    import re

    text = (SRC.parent / script).read_text()
    tree = ast.parse(text)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    names.update(re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text,
                            re.MULTILINE))
    roots = {n.split(".")[0] for n in names}
    assert "torch" in roots and "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(names)
