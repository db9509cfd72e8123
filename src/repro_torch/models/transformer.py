"""Transformer encoder stack: ``attn`` blocks with ``is_encoder`` (LayerNorm,
non-causal attention, GELU MLP). Counterpart of the encoder path of
``repro.models.transformer.forward``. The reference stacks the layers for a
``lax.scan``; here they are an ``nn.ModuleList``."""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def init_encoder_layer(cfg, mk):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "norm1": {"scale": mk((D,), init="ones"), "bias": mk((D,), init="zeros")},
        "attn": A.init_attention(cfg, mk),
        "norm2": {"scale": mk((D,), init="ones"), "bias": mk((D,), init="zeros")},
        "mlp": {"w_in": mk((D, F), scale=1.0 / math.sqrt(D)),
                "b_in": mk((F,), init="zeros"),
                "w_out": mk((F, D), scale=1.0 / math.sqrt(F)),
                "b_out": mk((D,), init="zeros")},
    }


def init_encoder(cfg, mk):
    """``init_model``'s tree for an encoder, with the layers unstacked."""
    D = cfg.d_model
    return {
        "embed": {"table": mk((cfg.vocab_size, D), scale=1.0 / math.sqrt(D))},
        "layers": [init_encoder_layer(cfg, mk) for _ in range(cfg.num_layers)],
        "final_norm": {"scale": mk((D,), init="ones"), "bias": mk((D,), init="zeros")},
        "lm_head": mk((D, cfg.vocab_size), scale=D ** -0.5),
    }


def encoder_layer(p, cfg, x, positions):
    h = L.layernorm(p.norm1.scale, p.norm1.bias, x, cfg.norm_eps)
    x = x + A.attn_forward(p.attn, cfg, h, positions, causal=False)
    h = L.layernorm(p.norm2.scale, p.norm2.bias, x, cfg.norm_eps)
    m = p.mlp
    return x + L.gelu_mlp(m.w_in, m.b_in, m.w_out, m.b_out, h)


class Encoder(nn.Module):
    """tokens (B, L) -> hidden (B, L, D) in bf16: the embedding is cast to
    bf16 on entry, and the hidden is returned before ``final_norm`` (which
    only an unembedding would apply)."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        if not (cfg.is_encoder and set(cfg.blocks) == {"attn"}):
            raise ValueError(f"{cfg.name}: only attn encoder stacks are ported")
        self.cfg = cfg
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(name, nn.Parameter(sub, requires_grad=False))
            else:
                self.add_module(name, L.tree_module(sub))

    @classmethod
    def init(cls, cfg, generator=None, *, dtype=torch.float32, device=None):
        """Random weights at ``init_model``'s scales, drawn from ``generator``
        on ``device`` (``None``: the GPU)."""
        return cls(cfg, init_encoder(cfg, L.Maker(generator, dtype, resolve_device(device))))

    @classmethod
    def from_state_dict(cls, cfg, state: dict):
        skeleton = cls(cfg, init_encoder(cfg, L.Maker(None, torch.float32, "meta")))
        skeleton.load_state_dict(state, assign=True)
        return skeleton

    def forward(self, tokens):
        x = L.embed(self.embed.table, tokens, dtype=torch.bfloat16)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        for layer in self.layers:
            x = encoder_layer(layer, self.cfg, x, positions)
        return x
