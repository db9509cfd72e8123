"""Transformer stacks. Counterpart of ``repro.models.transformer``:

* ``Encoder``      ``attn`` blocks with ``is_encoder`` (LayerNorm, non-causal
                   attention on the direct path, GELU MLP): the SD text
                   encoder;
* ``Transformer``  every stack of the reference's ten architectures: the
                   block kinds ``attn`` | ``swa`` (GQA or MLA attention,
                   then SwiGLU or MoE), ``rglru`` (Griffin recurrence, then
                   SwiGLU) and ``mlstm`` / ``slstm`` (xLSTM, no FFN);
                   DeepSeek's leading dense layers (``first_k_dense``);
                   ``d_ff == 0`` blocks; encoder stacks (LayerNorm,
                   non-causal attention, GELU MLP) with token or embedding
                   inputs. ``forward`` (train, scoring and prefill, with
                   caches and the summed MoE aux loss), ``decode_step``, the
                   cache preparation between them, ``decode_step_paged``
                   against the paged KV pools of ``paged_cache_specs``
                   (plain GQA attention stacks only), and the unembedding.

The reference stacks the layers into scan segments; here they are one
``nn.ModuleList`` in block order (``convert.model_items`` unstacks them in
that order), and layer i is a MoE layer when the config has experts and
i >= ``first_k_dense``. The reference's ``rules`` argument (sharding
hints inside a step) is not taken: the port's steps run on local tensors,
and its shardings are placed from outside (``repro_torch.dist``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL


def init_encoder_layer(cfg, mk):
    D = cfg.d_model
    return {"norm1": L.init_layernorm(mk, D), "attn": A.init_attention(cfg, mk),
            "norm2": L.init_layernorm(mk, D), "mlp": L.init_gelu_mlp(mk, D, cfg.d_ff)}


def init_encoder(cfg, mk):
    """``init_model``'s tree for an encoder, with the layers unstacked."""
    D = cfg.d_model
    return {
        "embed": L.init_embedding(mk, cfg.vocab_size, D),
        "layers": [init_encoder_layer(cfg, mk) for _ in range(cfg.num_layers)],
        "final_norm": L.init_layernorm(mk, D),
        "lm_head": mk((D, cfg.vocab_size), ("embed", "vocab"), scale=D ** -0.5),
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
        skeleton = cls(cfg, init_encoder(cfg, L.SpecMaker(torch.float32)))
        skeleton.load_state_dict(state, assign=True)
        return skeleton

    def forward(self, tokens):
        x = L.embed(self.embed.table, tokens, dtype=torch.bfloat16)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        for layer in self.layers:
            x = encoder_layer(layer, self.cfg, x, positions)
        return x


# -- the stacks ----------------------------------------------------------------

ATTN = ("attn", "swa")


def is_moe_layer(cfg, i: int) -> bool:
    """Layer i routes through experts: every layer past the leading dense ones."""
    return cfg.moe is not None and i >= cfg.moe.first_k_dense


def layer_window(cfg, kind: str, long_ctx: bool):
    """A block's attention window: the native one of ``swa`` blocks; on
    ``long_ctx`` the SWA substitute for full GQA attention; else None."""
    if kind == "swa":
        return cfg.sliding_window
    if kind == "attn" and long_ctx and cfg.mla is None:
        return cfg.long_context_window
    return None


def init_block(cfg, mk, kind: str, *, moe: bool = False):
    D = cfg.d_model
    norm = L.init_layernorm if cfg.is_encoder else L.init_rmsnorm
    p = {"norm1": norm(mk, D)}
    if kind in ATTN:
        p["attn"] = MLA.init_mla(cfg, mk) if cfg.mla is not None else A.init_attention(cfg, mk)
    elif kind == "rglru":
        p["mix"] = RG.init_rglru(cfg, mk)
    elif kind == "mlstm":
        p["mix"] = XL.init_mlstm(cfg, mk)
    elif kind == "slstm":
        p["mix"] = XL.init_slstm(cfg, mk)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind in ATTN + ("rglru",) and cfg.d_ff > 0:
        p["norm2"] = norm(mk, D)
        if moe:
            p["mlp"] = MOE.init_moe(cfg, mk)
        elif cfg.is_encoder:
            p["mlp"] = L.init_gelu_mlp(mk, D, cfg.d_ff)
        else:
            p["mlp"] = L.init_swiglu(mk, D, cfg.d_ff)
    return p


def init_model(cfg, mk):
    """``init_model``'s tree with the layers unstacked, in block order."""
    p = {}
    if not cfg.embedding_inputs:
        p["embed"] = L.init_embedding(mk, cfg.vocab_size, cfg.d_model)
    p["layers"] = [init_block(cfg, mk, kind, moe=is_moe_layer(cfg, i))
                   for i, kind in enumerate(cfg.blocks)]
    p["final_norm"] = (L.init_layernorm if cfg.is_encoder else L.init_rmsnorm)(mk, cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                          scale=cfg.d_model ** -0.5)
    return p


def _norm(cfg, p, x):
    if cfg.is_encoder:
        return L.layernorm(p.scale, p.bias, x, cfg.norm_eps)
    return L.rmsnorm(p.scale, x, cfg.norm_eps)


def _ffn(p, cfg, x, moe: bool):
    """A block's second half, x + FFN(norm2(x)) where the block has one.
    -> (x, the MoE aux loss or None)."""
    if not hasattr(p, "mlp"):
        return x, None
    h = _norm(cfg, p.norm2, x)
    if moe:
        y, aux = MOE.moe_forward(p.mlp, cfg, h)
        return x + y, aux
    if cfg.is_encoder:
        m = p.mlp
        return x + L.gelu_mlp(m.w_in, m.b_in, m.w_out, m.b_out, h), None
    return x + L.swiglu(p.mlp, h), None


def block_forward(p, cfg, kind: str, x, rope, *, moe: bool = False, window=None):
    """A block over the whole sequence at positions ``arange(S)``. -> (y,
    cache, aux or None)."""
    h = _norm(cfg, p.norm1, x)
    if kind in ATTN:
        causal = not cfg.is_encoder
        if cfg.mla is not None:
            S = x.shape[1]
            fwd = MLA.mla_forward_blocked if S > 2048 and S % 512 == 0 else MLA.mla_forward
            mix, cache = fwd(p.attn, cfg, h, rope, causal=causal)
        else:
            mix, cache = A.attn_forward_auto(p.attn, cfg, h, rope, causal=causal, window=window)
    elif kind == "rglru":
        mix, cache = RG.rglru_forward(p.mix, cfg, h)
    elif kind == "mlstm":
        mix, cache = XL.mlstm_forward(p.mix, cfg, h)
    elif kind == "slstm":
        mix, cache = XL.slstm_forward(p.mix, cfg, h)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x, aux = _ffn(p, cfg, x + mix, moe)
    return x, cache, aux


def block_decode(p, cfg, kind: str, x, cache, pos, rope, *, moe: bool = False, window=None,
                 shard=None):
    """One-token step; updates ``cache`` (a KV cache, latents or a recurrent
    state) in place; with a per-row ``pos`` (``attention.decode_pos`` with
    rows), the rows of a slot arena's pool; ``shard`` (``MeshShard``): this
    rank's share of a linear KV pool. -> (y, cache)."""
    h = _norm(cfg, p.norm1, x)
    if kind in ATTN:
        if cfg.mla is not None:
            mix, cache = MLA.mla_decode(p.attn, cfg, h, cache, pos, rope)
        elif "slot_pos" in cache:
            mix, cache = A.attn_decode_ring(p.attn, cfg, h, cache, pos, rope, window=window)
        else:
            mix, cache = A.attn_decode(p.attn, cfg, h, cache, pos, rope, window=window,
                                       shard=shard)
    elif kind in ("rglru", "mlstm", "slstm"):
        decode = {"rglru": RG.rglru_decode, "mlstm": XL.mlstm_decode,
                  "slstm": XL.slstm_decode}[kind]
        mix, cache = decode(p.mix, cfg, h, cache, rows=A.decode_pos(pos, x.device).row_index)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x, _ = _ffn(p, cfg, x + mix, moe)
    return x, cache


def block_decode_paged(p, cfg, x, pool, block_table, pos, rope, *, moe: bool = False,
                       window=None, phase=None, shard=None):
    """One-token step per row against the layer's paged pool (updated in
    place; ``shard``: this rank's share of it). -> (y, pool)."""
    h = _norm(cfg, p.norm1, x)
    mix, pool = A.attn_decode_paged(p.attn, cfg, h, pool, block_table, pos, rope,
                                    window=window, phase=phase, shard=shard)
    x, _ = _ffn(p, cfg, x + mix, moe)
    return x, pool


def cache_specs(cfg, batch: int, capacity: int, *, long_ctx: bool = False,
                dtype=torch.bfloat16, device=None):
    """One zero decode cache a layer, as ``prepare_decode_caches`` returns
    them: a linear KV cache of ``capacity``, or a ring of ``window`` slots
    (all empty) where the window is under it; MLA latents; recurrent
    states."""
    out = []
    for kind in cfg.blocks:
        if kind in ATTN and cfg.mla is not None:
            out.append(MLA.mla_cache_spec(cfg, batch, capacity, dtype=dtype, device=device))
        elif kind in ATTN:
            window = layer_window(cfg, kind, long_ctx)
            ring = window is not None and window < capacity
            out.append(A.cache_spec(cfg, batch, window if ring else capacity, ring=ring,
                                    dtype=dtype, device=device))
        elif kind == "rglru":
            out.append(RG.rglru_state_spec(cfg, batch, dtype=dtype, device=device))
        elif kind == "mlstm":
            out.append(XL.mlstm_state_spec(cfg, batch, device=device))
        else:
            out.append(XL.slstm_state_spec(cfg, batch, device=device))
    return out


def cache_axes(cfg, capacity: int, *, long_ctx: bool = False) -> list:
    """The logical axes of ``cache_specs``' leaves, layer by layer: the
    reference's ``cache_specs`` under an ``AxesMaker``, unstacked (the
    ``layers`` dim of its scan segments dropped)."""
    out = []
    for kind in cfg.blocks:
        if kind in ATTN and cfg.mla is not None:
            out.append(MLA.mla_cache_axes())
        elif kind in ATTN:
            window = layer_window(cfg, kind, long_ctx)
            out.append(A.cache_axes(ring=window is not None and window < capacity))
        elif kind == "rglru":
            out.append(RG.rglru_state_axes())
        elif kind == "mlstm":
            out.append(XL.mlstm_state_axes())
        else:
            out.append(XL.slstm_state_axes())
    return out


def check_pageable(cfg) -> None:
    """Raise ``ValueError`` for a stack the paged KV arena cannot hold, as the
    reference's ``paged_cache_specs`` does: pages hold GQA KV rows, and MLA
    latents and recurrent states have no page structure."""
    if cfg.mla is not None:
        raise ValueError("paged KV arena requires plain GQA attention "
                         "(MLA latent caches are not paged)")
    for kind in cfg.blocks:
        if kind not in ATTN:
            raise ValueError(f"paged KV arena requires attention blocks, got {kind!r}")


def paged_cache_specs(cfg, num_pages: int, page_size: int, *, kv_dtype: str = "bf16",
                      device=None):
    """One zero paged pool per layer (``attention.paged_cache_spec``); raises
    ``ValueError`` for stacks the paged arena cannot hold."""
    check_pageable(cfg)
    return [A.paged_cache_spec(cfg, num_pages, page_size, kv_dtype=kv_dtype, device=device)
            for _ in range(cfg.num_layers)]


def paged_cache_axes(cfg, *, kv_dtype: str = "bf16") -> list:
    """The logical axes of ``paged_cache_specs``' leaves, layer by layer."""
    check_pageable(cfg)
    return [A.paged_cache_axes(kv_dtype=kv_dtype) for _ in range(cfg.num_layers)]


def _pad_seq(t, capacity: int):
    """(B, S, ...) -> (B, capacity, ...), zeros past S."""
    pad = capacity - t.shape[1]
    if pad <= 0:
        return t
    out = t.new_zeros(t.shape[0], capacity, *t.shape[2:])
    out[:, :t.shape[1]] = t
    return out


class Transformer(nn.Module):
    """A stack of ``cfg.blocks``: tokens (B, S), or embeddings (B, S, D) for
    ``embedding_inputs``, -> hidden (B, S, D). Token embeddings are cast to
    bf16 on entry, as in the reference; embeddings enter as given."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        self.cfg = cfg
        L.adopt_tree(self, tree)

    @classmethod
    def init(cls, cfg, generator=None, *, dtype=torch.float32, device=None):
        """Random weights at ``init_model``'s scales, drawn from ``generator``
        on ``device`` (``None``: the GPU)."""
        return cls(cfg, init_model(cfg, L.Maker(generator, dtype, resolve_device(device))))

    @classmethod
    def from_state_dict(cls, cfg, state: dict):
        """From ``repro_torch.convert.from_jax_model_params`` (or
        ``state_dict()``); the tensors stay on their device."""
        skeleton = cls(cfg, init_model(cfg, L.SpecMaker(torch.float32)))
        skeleton.load_state_dict(state, assign=True)
        return skeleton

    def _window(self, kind: str, long_ctx: bool):
        return layer_window(self.cfg, kind, long_ctx)

    def _rope(self, positions):
        cfg = self.cfg
        dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
        return L.rope_tables(positions, dim, cfg.rope_theta)

    def embed_tokens(self, tokens):
        if self.cfg.embedding_inputs:
            raise ValueError(f"{self.cfg.name} takes embeddings, not tokens")
        return L.embed(self.embed.table, tokens, dtype=torch.bfloat16)

    def unembed(self, h):
        """Final norm and the tied (or ``lm_head``) projection; logits in h's
        dtype."""
        h = _norm(self.cfg, self.final_norm, h)
        if self.cfg.tie_embeddings:
            return h @ self.embed.table.to(h.dtype).T
        return h @ self.lm_head.to(h.dtype)

    def forward(self, inputs, *, want_caches: bool = False, long_ctx: bool = False,
                remat: bool = False):
        """The whole sequence at positions ``arange(S)``. -> (hidden, caches
        or None, aux): caches one a layer (attention {k, v} (B,S,K,hd), MLA
        {c, k_rope}, recurrent states), aux the summed MoE load-balance loss
        (float32, 0 without experts). With ``remat`` each layer runs under
        ``torch.utils.checkpoint`` (the reference's ``remat``): its
        activations are recomputed in the backward."""
        cfg = self.cfg
        x = inputs if cfg.embedding_inputs else self.embed_tokens(inputs)
        rope = self._rope(torch.arange(x.shape[1], device=x.device)[None])
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, layer) in enumerate(zip(cfg.blocks, self.layers)):
            kw = dict(moe=is_moe_layer(cfg, i), window=self._window(kind, long_ctx))
            if remat:
                x, cache, a = checkpoint(block_forward, layer, cfg, kind, x, rope,
                                         use_reentrant=False, **kw)
            else:
                x, cache, a = block_forward(layer, cfg, kind, x, rope, **kw)
            if want_caches:
                caches.append(cache)
            if a is not None:
                aux = aux + a
        return x, (caches if want_caches else None), aux

    def decode_step(self, token_embeds, caches, pos, *, rows=None, long_ctx: bool = False,
                    shard=None):
        """One token at ``pos`` for the whole stack; the caches are updated in
        place. ``pos`` a 0-d or one-element int32 tensor on the device (the
        step then reads no value on the host and can be captured in a CUDA
        graph) or a Python int; with ``rows`` (a slot arena: ``caches`` are
        pools of ``cache_specs`` rows, rings a row for windowed layers), the
        (B,) pool row of each batch row, read and written in place (KV rows
        and latents at the row's position, recurrent states whole), and a
        (B,) int32 tensor of per-row positions (RoPE, the cache write and
        the attention mask per row). ``shard`` (``attention.MeshShard``):
        the pools are this rank's share of a slot arena split over a mesh.
        -> (hidden (B,1,D), caches)."""
        cfg = self.cfg
        x = token_embeds
        pos = A.decode_pos(pos, x.device, rows)
        rope = self._rope(pos.pos.view(-1, 1))
        for i, (kind, layer, cache) in enumerate(zip(cfg.blocks, self.layers, caches)):
            x, _ = block_decode(layer, cfg, kind, x, cache, pos, rope, moe=is_moe_layer(cfg, i),
                                window=self._window(kind, long_ctx), shard=shard)
        return x, caches

    def decode_step_paged(self, token_embeds, pools, block_table, pos, *, phase=None,
                          long_ctx: bool = False, shard=None):
        """One token per row for the whole stack against the paged pools of
        ``paged_cache_specs`` (updated in place). token_embeds (B,1,D);
        block_table (B, nb) int32, one table per request-stream shared by
        every layer; pos (B,) int32 per-row positions, for RoPE and the
        masks; ``phase`` (B,) int32 marks a ragged pass list (rows at phase
        0 are padding: zero attention output, dropped writes); ``shard``
        (``attention.MeshShard``): the pools are this rank's share of a
        pool split over a mesh, the table global. -> (hidden (B,1,D),
        pools)."""
        cfg = self.cfg
        x = token_embeds
        rope = self._rope(pos[:, None])
        for i, (kind, layer, pool) in enumerate(zip(cfg.blocks, self.layers, pools)):
            x, _ = block_decode_paged(layer, cfg, x, pool, block_table, pos, rope,
                                      moe=is_moe_layer(cfg, i),
                                      window=self._window(kind, long_ctx), phase=phase,
                                      shard=shard)
        return x, pools

    def prepare_decode_caches(self, caches, *, seq_len: int, capacity: int,
                              long_ctx: bool = False):
        """Prefill caches -> decode caches: a GQA layer's ring of ``window``
        slots where its window is under ``capacity``, else its linear cache
        zero-padded to ``capacity`` (and under ``attention.kv_quant``
        quantized after the padding, as the reference does); MLA latents
        zero-padded to ``capacity``; recurrent states as they are."""
        out = []
        for kind, c in zip(self.cfg.blocks, caches):
            window = self._window(kind, long_ctx)
            if kind not in ATTN:
                out.append(c)
            elif self.cfg.mla is not None:
                out.append({n: _pad_seq(t, capacity) for n, t in c.items()})
            elif window is not None and window < capacity:
                out.append(A.cache_from_prefill(c, window=window, seq_len=seq_len))
            else:
                c = {n: _pad_seq(t, capacity) for n, t in c.items()}
                out.append(A.quantize_linear_cache(c) if A.kv_quant() else c)
        return out
