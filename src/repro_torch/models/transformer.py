"""Transformer stacks. Counterpart of ``repro.models.transformer``:

* ``Encoder``      ``attn`` blocks with ``is_encoder`` (LayerNorm, non-causal
                   attention, GELU MLP): the SD text encoder;
* ``Transformer``  the dense decoder, every block ``attn`` or ``swa`` (RMSNorm,
                   causal GQA attention, SwiGLU): ``forward`` with caches
                   (prefill), ``decode_step``, the cache preparation between
                   them, ``decode_step_paged`` against the paged KV pools of
                   ``paged_cache_specs`` (per-row positions), and the (tied)
                   unembedding.

The reference stacks the layers for a ``lax.scan``; here they are an
``nn.ModuleList``. The reference's sharding ``rules`` have no counterpart:
the port runs on one device.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        L.adopt_tree(self, tree)

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


# -- decoder -------------------------------------------------------------------


def _check_decoder(cfg) -> None:
    """Raise on what the dense decoder does not port yet."""
    later = [name for name, present in (
        ("MoE", cfg.moe is not None), ("MLA", cfg.mla is not None),
        ("rglru/xLSTM blocks", not set(cfg.blocks) <= {"attn", "swa"}),
        ("an encoder stack", cfg.is_encoder),
        ("embedding inputs", cfg.embedding_inputs)) if present]
    if later:
        raise ValueError(f"{cfg.name}: {', '.join(later)} not ported yet (a later slice, "
                         "ROADMAP A7); the decoder takes attn/swa stacks")


def init_block(cfg, mk):
    D = cfg.d_model
    p = {"norm1": L.init_rmsnorm(mk, D), "attn": A.init_attention(cfg, mk)}
    if cfg.d_ff > 0:
        p["norm2"] = L.init_rmsnorm(mk, D)
        p["mlp"] = L.init_swiglu(mk, D, cfg.d_ff)
    return p


def init_decoder(cfg, mk):
    """``init_model``'s tree for a dense decoder, with the layers unstacked."""
    p = {"embed": L.init_embedding(mk, cfg.vocab_size, cfg.d_model),
         "layers": [init_block(cfg, mk) for _ in range(cfg.num_layers)],
         "final_norm": L.init_rmsnorm(mk, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((cfg.d_model, cfg.vocab_size), scale=cfg.d_model ** -0.5)
    return p


def block_forward(p, cfg, x, rope, *, window):
    """-> (y, cache {k, v})."""
    h = L.rmsnorm(p.norm1.scale, x, cfg.norm_eps)
    mix, cache = A.attn_forward_auto(p.attn, cfg, h, rope, causal=True, window=window)
    x = x + mix
    if hasattr(p, "mlp"):
        x = x + L.swiglu(p.mlp, L.rmsnorm(p.norm2.scale, x, cfg.norm_eps))
    return x, cache


def block_decode(p, cfg, x, cache, pos, rope, *, window):
    """One-token step; updates ``cache`` in place. -> (y, cache)."""
    h = L.rmsnorm(p.norm1.scale, x, cfg.norm_eps)
    if "slot_pos" in cache:
        mix, cache = A.attn_decode_ring(p.attn, cfg, h, cache, pos, rope, window=window)
    else:
        mix, cache = A.attn_decode(p.attn, cfg, h, cache, pos, rope, window=window)
    x = x + mix
    if hasattr(p, "mlp"):
        x = x + L.swiglu(p.mlp, L.rmsnorm(p.norm2.scale, x, cfg.norm_eps))
    return x, cache


def block_decode_paged(p, cfg, x, pool, block_table, pos, rope, *, window, phase=None):
    """One-token step per row against the layer's paged pool (updated in
    place). -> (y, pool)."""
    h = L.rmsnorm(p.norm1.scale, x, cfg.norm_eps)
    mix, pool = A.attn_decode_paged(p.attn, cfg, h, pool, block_table, pos, rope,
                                    window=window, phase=phase)
    x = x + mix
    if hasattr(p, "mlp"):
        x = x + L.swiglu(p.mlp, L.rmsnorm(p.norm2.scale, x, cfg.norm_eps))
    return x, pool


def paged_cache_specs(cfg, num_pages: int, page_size: int, *, kv_dtype: str = "bf16",
                      device=None):
    """One zero paged pool per layer (``attention.paged_cache_spec``); raises
    ``ValueError`` for stacks the paged arena cannot hold."""
    _check_decoder(cfg)
    return [A.paged_cache_spec(cfg, num_pages, page_size, kv_dtype=kv_dtype, device=device)
            for _ in range(cfg.num_layers)]


class Transformer(nn.Module):
    """The dense decoder: tokens (B, S) -> hidden (B, S, D) in bf16 (the
    embedding is cast to bf16 on entry, as in the reference)."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        _check_decoder(cfg)
        self.cfg = cfg
        L.adopt_tree(self, tree)

    @classmethod
    def init(cls, cfg, generator=None, *, dtype=torch.float32, device=None):
        """Random weights at ``init_model``'s scales, drawn from ``generator``
        on ``device`` (``None``: the GPU)."""
        _check_decoder(cfg)
        return cls(cfg, init_decoder(cfg, L.Maker(generator, dtype, resolve_device(device))))

    @classmethod
    def from_state_dict(cls, cfg, state: dict):
        """From ``repro_torch.convert.from_jax_model_params`` (or
        ``state_dict()``); the tensors stay on their device."""
        skeleton = cls(cfg, init_decoder(cfg, L.Maker(None, torch.float32, "meta")))
        skeleton.load_state_dict(state, assign=True)
        return skeleton

    def _window(self, kind: str, long_ctx: bool):
        if kind == "swa":
            return self.cfg.sliding_window
        if long_ctx:
            return self.cfg.long_context_window    # the SWA substitute on long_500k
        return None

    def _rope(self, positions):
        return L.rope_tables(positions, self.cfg.resolved_head_dim, self.cfg.rope_theta)

    def embed_tokens(self, tokens):
        return L.embed(self.embed.table, tokens, dtype=torch.bfloat16)

    def unembed(self, h):
        """Final norm and the tied (or ``lm_head``) projection; logits in h's
        dtype."""
        h = L.rmsnorm(self.final_norm.scale, h, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return h @ self.embed.table.to(h.dtype).T
        return h @ self.lm_head.to(h.dtype)

    def forward(self, tokens, *, want_caches: bool = False, long_ctx: bool = False,
                remat: bool = False):
        """Prefill at positions ``arange(S)``. -> (hidden, caches or None);
        caches are one {k, v} (B,S,K,hd) per layer. With ``remat`` each
        layer runs under ``torch.utils.checkpoint`` (the reference's
        ``remat``): its activations are recomputed in the backward."""
        x = self.embed_tokens(tokens)
        rope = self._rope(torch.arange(x.shape[1], device=x.device)[None])
        caches = []
        for kind, layer in zip(self.cfg.blocks, self.layers):
            window = self._window(kind, long_ctx)
            if remat:
                x, cache = checkpoint(block_forward, layer, self.cfg, x, rope, window=window,
                                      use_reentrant=False)
            else:
                x, cache = block_forward(layer, self.cfg, x, rope, window=window)
            caches.append(cache)
        return x, (caches if want_caches else None)

    def decode_step(self, token_embeds, caches, pos, *, rows=None, long_ctx: bool = False):
        """One token at ``pos`` for the whole stack; the caches are updated in
        place. ``pos`` a 0-d or one-element int32 tensor on the device (the
        step then reads no value on the host and can be captured in a CUDA
        graph) or a Python int; with ``rows``, the (B,) cache row of each
        batch row (a slot arena's rows, read and written in place), a (B,)
        int32 tensor of per-row positions (RoPE, the cache write and the
        attention mask per row). -> (hidden (B,1,D), caches)."""
        x = token_embeds
        pos = A.decode_pos(pos, x.device, rows)
        rope = self._rope(pos.pos.view(-1, 1))
        for kind, layer, cache in zip(self.cfg.blocks, self.layers, caches):
            x, _ = block_decode(layer, self.cfg, x, cache, pos, rope,
                                window=self._window(kind, long_ctx))
        return x, caches

    def decode_step_paged(self, token_embeds, pools, block_table, pos, *, phase=None,
                          long_ctx: bool = False):
        """One token per row for the whole stack against the paged pools of
        ``paged_cache_specs`` (updated in place). token_embeds (B,1,D);
        block_table (B, nb) int32, one table per request-stream shared by
        every layer; pos (B,) int32 per-row positions, for RoPE and the
        masks; ``phase`` (B,) int32 marks a ragged pass list (rows at phase
        0 are padding: zero attention output, dropped writes). -> (hidden
        (B,1,D), pools)."""
        x = token_embeds
        rope = self._rope(pos[:, None])
        for kind, layer, pool in zip(self.cfg.blocks, self.layers, pools):
            x, _ = block_decode_paged(layer, self.cfg, x, pool, block_table, pos, rope,
                                      window=self._window(kind, long_ctx), phase=phase)
        return x, pools

    def prepare_decode_caches(self, caches, *, seq_len: int, capacity: int,
                              long_ctx: bool = False):
        """Prefill caches -> decode caches: a ring of ``window`` slots where
        the layer's window is under ``capacity``, else the linear cache
        zero-padded to ``capacity``."""
        out = []
        for kind, c in zip(self.cfg.blocks, caches):
            window = self._window(kind, long_ctx)
            if window is not None and window < capacity:
                out.append(A.cache_from_prefill(c, window=window, seq_len=seq_len))
            elif capacity > seq_len:
                lin = A.cache_spec(self.cfg, c["k"].shape[0], capacity, dtype=c["k"].dtype,
                                   device=c["k"].device)
                lin["k"][:, :seq_len] = c["k"]
                lin["v"][:, :seq_len] = c["v"]
                out.append(lin)
            else:
                out.append(c)
        return out
