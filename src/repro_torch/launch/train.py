"""Training launcher for every architecture. Counterpart of
``repro/launch/train.py``: decoders train on next tokens of the synthetic
k-gram token stream (``lm_loss``, the MoE aux loss included), encoders
(hubert-xlarge) on masked prediction of the synthetic audio frames' units
(``masked_prediction_loss``); AdamW with 20 warmup steps, eager steps on
one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 200 --batch 16 --seq 128 --device cpu

``--device`` defaults to the GPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.synthetic import audio_frames, lm_batches
from repro_torch.dist.sharding import mesh_sizes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import Transformer
from repro_torch.train import losses
from repro_torch.train.loop import make_train_step, train
from repro_torch.train.optimizer import AdamWConfig

MAX_ORDER2_VOCAB = 8192


def lm_loss_fn(model: Transformer, *, remat: bool = False):
    """The loss of ``loop.train`` for batches ``{"tokens": (B, S) int64}``."""
    def loss_fn(_params, batch, _generator):
        return losses.lm_loss(model, batch["tokens"], remat=remat)
    return loss_fn


def masked_loss_fn(model: Transformer, *, remat: bool = False):
    """The loss of ``loop.train`` for batches ``{"features", "targets",
    "mask"}`` (``frame_batches``)."""
    def loss_fn(_params, batch, _generator):
        return losses.masked_prediction_loss(model, batch["features"], batch["targets"],
                                             batch["mask"], remat=remat)
    return loss_fn


def lm_step(model: Transformer, opt_cfg: AdamWConfig, *, remat: bool = False):
    """The eager train step over ``model``'s parameters
    (``loop.make_train_step``)."""
    return make_train_step(lm_loss_fn(model, remat=remat), opt_cfg)


def token_batches(rng: np.random.Generator, vocab: int, batch: int, seq: int, device):
    """``lm_batches`` of (batch, seq + 1) tokens as ``{"tokens": ...}`` on
    ``device``: the reference trains on seq + 1 tokens a row. Its
    second-order transition table holds vocab^2 int64 entries (131 GB at
    llama3.2-1b's 128,256), so past ``MAX_ORDER2_VOCAB`` tokens the stream
    is first-order; the reduced configs keep the reference's stream."""
    order = 2 if vocab <= MAX_ORDER2_VOCAB else 1
    for arr in lm_batches(rng, vocab, batch, seq + 1, order=order):
        yield {"tokens": torch.from_numpy(arr).long().to(device)}


def frame_batches(rng: np.random.Generator, batch: int, frames: int, dim: int, vocab: int,
                  device):
    """``audio_frames`` batches on ``device``: the frames (float32, zeroed
    where masked), their units and the mask of scored frames."""
    while True:
        feats, units, mask = audio_frames(rng, batch, frames, dim, vocab)
        yield {"features": torch.from_numpy(feats).to(device),
               "targets": torch.from_numpy(units).long().to(device),
               "mask": torch.from_numpy(mask).to(device)}


def main(argv=None) -> list:
    """-> the logged history (one dict a logged step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    if args.arch not in list_archs():
        raise ValueError(f"unknown arch {args.arch!r}; the port trains {list_archs()}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    mesh = make_host_mesh(device=dev.type)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} device={dev} "
          f"mesh={mesh_sizes(mesh)}")

    model = Transformer.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev).requires_grad_(True)
    params = dict(model.named_parameters())
    print(f"params: {sum(p.numel() for p in params.values()) / 1e6:.1f}M")

    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    rng = np.random.default_rng(args.seed)
    if cfg.is_encoder:
        batches = frame_batches(rng, args.batch, args.seq, cfg.d_model, cfg.vocab_size, dev)
        loss_fn = masked_loss_fn(model)
    else:
        batches = token_batches(rng, cfg.vocab_size, args.batch, args.seq, dev)
        loss_fn = lm_loss_fn(model)
    _, _, history = train(params, loss_fn, batches, opt, num_steps=args.steps,
                          ckpt_dir=args.ckpt_dir, log_every=10, seed=args.seed)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return history


if __name__ == "__main__":
    main()
