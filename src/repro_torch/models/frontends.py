"""The text frontend of the SD pipeline: a small transformer encoder standing
in for CLIP's text tower. Counterpart of ``repro/models/frontends.py``."""

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
