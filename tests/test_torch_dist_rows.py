"""Row-parallel GEMMs for the backends that quantize per call or are
weight-only (``distributed.tensor_parallel.row_dense``): each rank holds K
/ tp rows of ``wo`` and the matching slice of the input, on (1, 2) and
(1, 4) gloo meshes, held to the single-device ``qdense`` of the whole
weight and input:

  * ``int_sim``, ``lut4`` (from float masters; 4-bit, and ``int_sim`` at
    8-bit activations) and ``netlist``: global scales, exact integer
    partials summed, then the scales: ``torch.equal``;
  * ``w4a16`` from masters (per channel; grouped with G = 128 over K =
    384, so at tp 2 and 4 a group is split between ranks) and packed
    ``w4a16_packed`` (per channel and grouped, whole groups a rank): the
    f32 partials summed, within relative 1e-4 of the largest output
    (another order of the f32 sum).

Each master case is also held to the JAX package's single-device
``qdense`` on the same numpy inputs within ``test_torch_backends.py``'s
1e-5, and the collective ledger shows that no call all-gathers (a weight
or anything else): the max-reduces of the scales and the sum of the
partials are all-reduces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

TPS = (2, 4)
M, N = 6, 48
#: (name, backend, group size, activation bits, packed, K)
CASES = (("int_sim", "int_sim", 0, 4, False, 256),
         ("int_sim_a8", "int_sim", 0, 8, False, 256),
         ("lut4", "lut4", 0, 4, False, 256),
         ("netlist", "netlist", 0, 4, False, 256),
         ("w4a16_channel", "w4a16", 0, 4, False, 256),
         ("w4a16_grouped", "w4a16", 128, 4, False, 384),
         ("w4a16_packed_channel", "w4a16_packed", 0, 4, True, 256),
         ("w4a16_packed_grouped", "w4a16_packed", 64, 4, True, 256))
EXACT = ("int_sim", "int_sim_a8", "lut4", "netlist")
W4A16_RTOL = 1e-4
JAX_TOL = 1e-5

JAX_SCRIPT = r"""
import json, sys
import jax.numpy as jnp, numpy as np
from repro.core import qlinear as jql

d, cases = sys.argv[1], json.loads(sys.argv[2])
for name, backend, G, a_bits, packed, K in cases:
    if packed:
        continue
    with np.load(f"{d}/{name}.npz") as z:
        w, x = z["w"], z["x"]
    qc = jql.QuantConfig(backend=backend, group_size=G, a_bits=a_bits)
    np.save(f"{d}/{name}_jax.npy",
            np.asarray(jql.qdense(jnp.asarray(w), jnp.asarray(x), qc)))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("dist_rows")
    rng = np.random.default_rng(31)
    for name, *_, K in CASES:
        np.savez(d / f"{name}.npz",
                 w=(rng.standard_normal((K, N)) * 0.05).astype(np.float32),
                 x=(rng.standard_normal((M, K)) * 3).astype(np.float32))
    W.run_jax(JAX_SCRIPT, [d, json.dumps(CASES)], n_devices=1)
    cases = [c[:5] for c in CASES]
    for tp in TPS:
        W.spawn(W.rows_worker, tp, d, str(d), tp, cases)
    return d, {tp: torch.load(d / f"rows_tp{tp}.pt", weights_only=False)
               for tp in TPS}


def _single(d, case):
    from repro_torch.core.qlinear import (QuantConfig, pack_weight_nd,
                                          prepack_tree, qdense)

    name, backend, G, a_bits, packed, _ = case
    with np.load(d / f"{name}.npz") as z:
        w, x = torch.from_numpy(z["w"]), torch.from_numpy(z["x"])
    qc = QuantConfig(backend=backend, group_size=G, a_bits=a_bits)
    if packed:
        w = prepack_tree({"wo": pack_weight_nd(w, qc)})["wo"]
    with torch.no_grad():
        return qdense(w, x, qc).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("tp", TPS)
def test_row_parallel_equals_the_single_device_gemm(runs, case, tp):
    d, res = runs
    got = res[tp][case[0]]["y"]
    want = _single(d, case)
    if case[0] in EXACT:
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    else:
        err = np.abs(got - want).max()
        assert err <= W4A16_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("case", [c for c in CASES if not c[4]],
                         ids=[c[0] for c in CASES if not c[4]])
def test_row_parallel_against_the_jax_package(runs, case):
    d, res = runs
    want = np.load(d / f"{case[0]}_jax.npy")
    for tp in TPS:
        np.testing.assert_allclose(res[tp][case[0]]["y"], want,
                                   rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("tp", TPS)
def test_no_row_parallel_call_gathers(runs, tp):
    """Every collective of every case is an all-reduce (the scales' max,
    the partials' sum), never an all-gather; the integer cases move one
    [M, N] partial and the max of [M, 1] (and [1, N]) amaxes."""
    _, res = runs
    for name, backend, *_ in CASES:
        kinds = [k for k, _, _ in res[tp][name]["log"]]
        assert kinds and set(kinds) == {"all-reduce"}, (name, kinds)
        sizes = sorted(n for _, n, _ in res[tp][name]["log"])
        assert sizes[-1] == M * N * 4, (name, sizes)
