"""Every config's model code under a mesh: the reduced configs' lm_loss and
gradients on (2, 2) and (1, 4) gloo meshes (CPU) against the port's single
process, in float32 with the float backend.  This reaches every
mesh-aware site: the vocabulary-parallel embedding and cross-entropy, the
tensor-parallel attention (M-RoPE, qk-norm, sliding windows, biases), the
SwiGLU and GELU FFNs, Mamba-2's and RG-LRU's sharded projections, and the
MoE block's expert-parallel path with its FSDP gather.

The MoE block's capacity and aux loss are per data shard, in the JAX
package too: with two data ranks the MoE configs are held to the mean of
two single-process runs, one on each rank's rows (the mean of their
losses and of their gradients is what the mesh computes).

Tolerances: the loss within rtol 1e-5, each gradient within rtol 1e-4 /
atol 1e-6 (partial sums over ``model`` and the data ranks' sums add in
another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402

ARCHS = sorted(REGISTRY)
SHAPES = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_configs")
    W.spawn(W.configs_worker, 4, d, str(d / "out.pt"), ARCHS, SHAPES)
    return torch.load(d / "out.pt", weights_only=False)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_config_loss_and_gradients_on_a_mesh(runs, arch, shape):
    loss, grads = runs[(arch, tuple(shape))]
    dp = shape[0]
    if REGISTRY[arch].n_experts and dp > 1:
        parts = [W.config_loss(arch, part=(i, dp)) for i in range(dp)]
        want_loss = np.mean([p[0] for p in parts])
        want = {k: np.mean([p[1][k] for p in parts], axis=0)
                for k in parts[0][1]}
    else:
        want_loss, want = W.config_loss(arch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert sorted(grads) == sorted(want)
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
