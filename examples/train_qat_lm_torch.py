"""Train a ~100M-parameter LM with W4A4 QAT (the paper's 4-bit arithmetic
as the training-time feature) with the PyTorch port, on an NVIDIA GPU.

A scaled-down qwen2-family config (12 layers, d_model 768, vocab 32000),
the synthetic data pipeline, AdamW with warm-up and cosine decay,
checkpoints with resume and the step watchdog: the port's trainer
(``repro_torch.launch.train``).  Every projection goes through the
``fake_quant`` straight-through estimator (W4A4 in the forward, float
gradients).

    PYTHONPATH=src python examples/train_qat_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_qat_lm_torch.py --device cpu \\
        --reduced --steps 12 --lr 3e-2

``--reduced`` trains qwen2-0.5b's reduced test config (2 layers, d_model
64) instead; ``--device cpu`` runs on the CPU.
"""

import argparse
import dataclasses
import logging
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import train
from repro_torch.optim.adamw import tree_leaves


def hundred_m_config() -> ArchConfig:
    """~100M-parameter dense config (qwen2 family, shrunk depth and
    width)."""
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=2, head_dim=64, d_ff=2048, vocab=32000)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_qat_100m"))
    ap.add_argument("--reduced", action="store_true",
                    help="qwen2-0.5b's reduced test config instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_config("qwen2-0.5b").reduced(n_layers=2) if args.reduced
           else hundred_m_config())
    state, history = train(
        cfg.name, cfg=cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt, save_every=100, peak_lr=args.lr,
        quant_backend="fake_quant", device=args.device)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"params: {n_params / 1e6:.1f}M (QAT backend: fake_quant W4A4) "
          f"on {args.device}")
    print(f"loss: {history[0]:.3f} -> {history[-1]:.3f} "
          f"over {len(history)} steps")
    assert history[-1] < history[0], "loss should decrease"
    return history


if __name__ == "__main__":
    main()
