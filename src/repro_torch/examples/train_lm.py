"""End-to-end training: train a ~100M-parameter llama-family model
for a few hundred steps on the synthetic k-gram stream and show the loss
curve. Counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

The stream is first-order at this 32,000-token vocabulary, as the port's
training launcher makes it past ``launch.train.MAX_ORDER2_VOCAB``: the
reference's second-order table would hold 32000^2 int64 entries (8 GB).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.train import MAX_ORDER2_VOCAB, lm_loss_fn
from repro_torch.models.transformer import Transformer
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None) -> list:
    """-> the loss history (one dict a logged step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # ~100M params: llama3.2-1b family, 8 layers, d=768
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"), name="llama-100m", num_layers=8,
        d_model=768, num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32000, tie_embeddings=True)
    model = Transformer.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    print(f"model: {cfg.name}  params={sum(p.numel() for p in params.values()) / 1e6:.1f}M "
          f"on {dev}")

    order = 2 if cfg.vocab_size <= MAX_ORDER2_VOCAB else 1
    it = lm_batches(np.random.default_rng(0), cfg.vocab_size, args.batch, args.seq, order=order)

    def batches():
        for arr in it:
            yield {"tokens": torch.from_numpy(arr).long().to(dev)}

    opt = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)
    _, _, hist = train(params, lm_loss_fn(model), batches(), opt, num_steps=args.steps,
                       log_every=min(20, args.steps))
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
