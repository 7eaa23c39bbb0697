"""The paged serving steps under a tensor-parallel mesh: flash prefill and
the fused paged decode on (1, 2) and (1, 4) gloo meshes (reduced qwen3-4b,
float32, through the plain versions), against the port's single process.

Split from ``tests/test_torch_dist_w4a4.py``, whose module fixture (the
JAX package's mesh steps in a subprocess and the W4A4 ranks) took ~30 s of
its ~40 s alone: here each test spawns its own ranks and needs no JAX
reference, so the two files run on two workers.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402

TPS = (2, 4)


def _greedy(logits, vocab):
    return [np.argmax(l[:, :vocab], -1).tolist() for l in logits]


#: 4 heads over 2 KV heads ("head" at tp 2, duplicated KV heads at tp 4)
#: and 6 heads over 2 ("seq" for the 8-token prefill, "none" for decode,
#: at tp 4)
PAGED_CASES = {2: [("qwen3", dict(arch="qwen3-4b", n_layers=2))],
               4: [("qwen3", dict(arch="qwen3-4b", n_layers=2)),
                   ("odd_heads", dict(arch="qwen3-4b", n_layers=2,
                                      n_heads=6, n_kv_heads=2))]}


@pytest.mark.parametrize("tp", TPS)
def test_flash_prefill_and_fused_paged_decode_run_under_tp(tmp_path, tp):
    """Under a (1, tp) mesh the paged serving steps still go through flash
    prefill (on each rank's heads or query positions) and the fused paged
    decode (on the gathered heads), once a layer a step, and their logits
    are the single process's within 1e-5 (float32; greedy tokens equal)."""
    from repro_torch.configs import get_config

    out = tmp_path / "paged.pt"
    W.spawn(W.paged_tp_worker, tp, tmp_path, str(out), PAGED_CASES[tp])
    res = torch.load(out, weights_only=False)
    for name, kw in PAGED_CASES[tp]:
        kw = dict(kw)
        cfg = get_config(kw.pop("arch")).reduced(**kw)
        want, want_calls = W.paged_kernel_steps(cfg)
        got, calls = res[name]
        assert calls == want_calls == {
            "flash_prefill": cfg.n_layers,
            "paged_decode_attention": 3 * cfg.n_layers}, name
        assert _greedy(got, cfg.vocab) == _greedy(want, cfg.vocab), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def test_failed_rank_leaves_its_exit_code_and_stderr(tmp_path):
    """When a rank dies, `spawn` raises with every rank's exit code and the
    end of its standard error, and leaves both under the test's tmp dir:
    an intermittent failure of the ranks above shows its cause."""
    with pytest.raises(AssertionError) as info:
        W.spawn(W.dying_rank_worker, 2, tmp_path)
    msg = str(info.value)
    assert "rank 1 (exit 7)" in msg and "rank 1 exits with 7" in msg
    logs = tmp_path / "ranks_dying_rank_worker_2"
    codes = json.loads((logs / "exitcodes.json").read_text())["exitcodes"]
    assert codes[1] == 7 and codes[0] != 0
    assert "rank 1 exits with 7" in (logs / "rank1.stderr").read_text()
