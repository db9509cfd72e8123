"""Modality frontends. Counterpart of ``repro/models/frontends.py``.

* the SD pipeline's text frontend: a small transformer encoder standing in
  for CLIP's text tower;
* audio (HuBERT's conv codec) and vision (a VQ tokenizer) are stubs, as in
  the reference: the models take frame embeddings or token ids, and these
  helpers draw synthetic stand-ins from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def text_encoder_config(vocab: int, dim: int, length: int) -> ModelConfig:
    return ModelConfig(
        name="text-encoder", family="encoder", num_layers=4, d_model=dim,
        num_heads=max(2, dim // 64), num_kv_heads=max(2, dim // 64),
        d_ff=4 * dim, vocab_size=vocab, is_encoder=True)


def encode_text(encoder, tokens):
    """tokens (B, L) int -> (B, L, d_model) bf16."""
    return encoder(tokens)


def null_tokens(batch: int, length: int, device):
    """The CFG null prompt: the all-zero (pad) token sequence."""
    return torch.zeros((batch, length), dtype=torch.int64, device=device)


def synthetic_audio_frames(generator: torch.Generator, batch: int, frames: int, dim: int,
                           dtype=torch.bfloat16):
    """Stand-in for the HuBERT conv feature extractor's output: (batch,
    frames, dim) standard normal, on the generator's device."""
    return torch.randn(batch, frames, dim, generator=generator, dtype=torch.float32,
                       device=generator.device).to(dtype)


def synthetic_image_tokens(generator: torch.Generator, batch: int, n_patches: int, vocab: int,
                           image_token_base: int = 0):
    """Stand-in for a VQ image tokenizer (Chameleon's early fusion): (batch,
    n_patches) ids in [image_token_base, vocab)."""
    return torch.randint(image_token_base, vocab, (batch, n_patches), generator=generator,
                         device=generator.device)
