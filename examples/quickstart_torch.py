"""Quickstart (PyTorch port): the paper's 4-bit multiplier, from gate level
to GEMM, on an NVIDIA GPU.

  1. simulate the exact 11-LUT/2-CARRY4 netlist on the card and verify all
     256 products;
  2. compare area/delay against the prior design (paper Tables II/III;
     the FPGA model's numbers, not the GPU's);
  3. multiply int4 tensors with the table-lookup CUDA kernel (``ops.mul4``,
     the paper's mechanism: every product read from a 256-entry table);
  4. run a quantized GEMM through the fused W4A4 CUDA kernel (``int_sim``)
     and through the bit-exact netlist oracle, and check they are equal.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    analyze, build_lm_mult4, build_proposed_mult4, resources,
)
from repro_torch.core.qlinear import QuantConfig, qdense
from repro_torch.kernels import ops
from repro_torch.serving.engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. the paper's circuit, bit-exact ------------------------------------
    netlist = build_proposed_mult4()
    a = torch.arange(16, dtype=torch.uint8, device=dev)[:, None].expand(16, 16)
    b = a.t()
    products = netlist(a, b, mode="init")         # evaluate INIT truth tables
    assert torch.equal(products, (a.int() * b.int()).to(torch.uint8))
    print(f"[1] proposed netlist on {dev}: all 256 products exact "
          "(INIT-table mode)")
    print(f"    LUT1 INIT = 0x{netlist.init_table()['LUT1']:016X} "
          "(matches paper Table I)")

    # 2. area / delay vs the prior design (FPGA model) ----------------------
    for nl in (netlist, build_lm_mult4()):
        r, t = resources(nl), analyze(nl)
        print(f"[2] {nl.name:9s} LUTs={r['luts']:2d} CARRY4={r['carry4']} "
              f"CPD={t['cpd']:.3f} ns (logic {t['logic']:.3f} / net "
              f"{t['net']:.3f}; Artix-7 timing model)")

    # 3. the table-lookup kernel (the mechanism on the card) ----------------
    rng = np.random.default_rng(0)
    qa = torch.from_numpy(rng.integers(-8, 8, (4, 64), np.int8)).to(dev)
    qb = torch.from_numpy(rng.integers(-8, 8, (4, 64), np.int8)).to(dev)
    prod = ops.mul4(qa, qb)
    assert torch.equal(prod.int(), qa.int() * qb.int())
    print("[3] lut_mul4 kernel: exact on random int4 tensors")

    # 4. quantized GEMM: the W4A4 kernel vs the circuit oracle --------------
    w = torch.from_numpy(rng.standard_normal((32, 16), np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((4, 32), np.float32)).to(dev)
    y_int = qdense(w * 0.1, x, QuantConfig(backend="int_sim"))
    y_net = qdense(w * 0.1, x, QuantConfig(backend="netlist"))
    assert torch.equal(y_int, y_net)
    print("[4] W4A4 GEMM: fused int4 kernel == gate-level netlist oracle, "
          "bit for bit")
    print("quickstart OK")


if __name__ == "__main__":
    main()
