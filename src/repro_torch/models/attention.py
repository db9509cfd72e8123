"""GQA attention: RoPE, qk-norm, sliding windows, linear and ring decode
caches. Counterpart of ``repro.models.attention``.

* ``attn_forward``       the direct O(S^2)-scores path, positions given (the
                         SD text encoder's path);
* ``attn_forward_auto``  prefill at positions ``arange(S)``: the flash
                         kernel for CUDA tensors at every S, its plain
                         version (the same math as ``attn_forward``) on the
                         CPU;
* ``attn_decode``        one token vs a linear cache, written in place, then
                         the flash-decode kernel (CUDA) or its plain version;
* ``attn_decode_ring``   one token vs a ring buffer of ``window`` slots,
                         plain torch;
* ``attn_decode_paged``  one token per row vs the shared paged KV pool
                         through block tables, per-row positions, then the
                         paged/ragged decode kernels (CUDA) or their plain
                         version; ``paged_scatter_prefill`` writes a
                         batched prefill's KV into the pool.

The decoder paths take RoPE tables (``layers.rope_tables``) that the stack
computes once per forward. Grouped-head products never replicate KV.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import paged_decode_attention as KP
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import layers as L


def init_attention(cfg, mk):
    D, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": mk((D, H, hd), scale=1 / math.sqrt(D)),
        "wk": mk((D, K, hd), scale=1 / math.sqrt(D)),
        "wv": mk((D, K, hd), scale=1 / math.sqrt(D)),
        "wo": mk((H, hd, D), scale=1 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), init="ones")
        p["k_norm"] = mk((hd,), init="ones")
    return p


def attn_forward(p, cfg, x, positions, *, causal=True, window=None):
    """x (B,S,D), positions (B|1, S) -> (B,S,D). Scores and softmax in
    float32, everything else in x's dtype. Non-causal attention masks
    nothing: padding tokens are attended, as in the reference."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if cfg.qk_norm:
        q, k = L.head_rmsnorm(p.q_norm, q), L.head_rmsnorm(p.k_norm, k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if causal or window is not None:
        qpos = positions[:, None, None, :, None]
        kpos = positions[:, None, None, None, :]
        mask = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
    ctx = KF.grouped_attention_plain(q, k, v, mask)
    return torch.einsum("bqhk,hkd->bqd", ctx, p.wo.to(dt))


def _qkv(p, cfg, x, rope):
    """x (B,S,D) -> q (B,S,H,hd), k, v (B,S,K,hd), contiguous, in x's dtype;
    qk-norm, then RoPE from the (cos, sin) tables."""
    dt = x.dtype
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq.to(dt).reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (x @ p.wk.to(dt).reshape(D, K * hd)).reshape(B, S, K, hd)
    v = (x @ p.wv.to(dt).reshape(D, K * hd)).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q, k = L.head_rmsnorm(p.q_norm, q), L.head_rmsnorm(p.k_norm, k)
    return L.apply_rope_tables(q, *rope), L.apply_rope_tables(k, *rope), v


def _out_proj(p, ctx):
    """ctx (B,Q,H,hd) -> (B,Q,D)."""
    B, Q, H, hd = ctx.shape
    return ctx.reshape(B, Q, H * hd) @ p.wo.to(ctx.dtype).reshape(H * hd, -1)


def attn_forward_auto(p, cfg, x, rope, *, causal=True, window=None):
    """Prefill at positions ``arange(S)`` (``rope`` from those). x (B,S,D)
    -> (out (B,S,D), cache {k, v} (B,S,K,hd))."""
    q, k, v = _qkv(p, cfg, x, rope)
    ctx = KF.flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(p, ctx), {"k": k, "v": v}


def attn_decode(p, cfg, x, cache, pos: int, rope, *, window=None):
    """One token at ``pos`` vs a linear cache {k, v} (B,S,K,hd). Writes the
    new K/V at ``pos`` in place (the reference updates functionally), then
    attends to keys ``<= pos`` (and inside ``window``). x (B,1,D) ->
    (out (B,1,D), cache)."""
    q, k_new, v_new = _qkv(p, cfg, x, rope)
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    ctx = KD.decode_attention(q[:, 0], cache["k"], cache["v"], pos, window=window)
    return _out_proj(p, ctx[:, None]), cache


def attn_decode_ring(p, cfg, x, cache, pos: int, rope, *, window: int):
    """One token vs a ring buffer {k, v (B,W,K,hd), slot_pos (W,) int32
    absolute positions, -1 = empty}, updated in place at slot pos % W."""
    W = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, cfg, x, rope)
    slot = pos % W
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["slot_pos"][slot] = pos
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - window)
    ctx = KD.decode_attention_plain(q[:, 0], cache["k"], cache["v"], pos, valid=valid)
    return _out_proj(p, ctx[:, None]), cache


def cache_spec(cfg, batch: int, capacity: int, *, dtype=torch.bfloat16, device=None):
    """A zero linear decode cache {k, v (batch, capacity, K, hd)} on
    ``device`` (None: the GPU). (Ring caches come from
    ``cache_from_prefill``.)"""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    device = resolve_device(device)
    return {"k": torch.zeros(batch, capacity, K, hd, dtype=dtype, device=device),
            "v": torch.zeros(batch, capacity, K, hd, dtype=dtype, device=device)}


def cache_from_prefill(kv, *, window: int | None, seq_len: int):
    """Prefill {k, v} (B,S,K,hd) -> the decode cache. ``window=None``: the
    linear cache, padded to capacity by the caller. ``window=W``: a ring of
    W slots holding the last W positions, position p at slot p % W, in the
    slot order of the reference's argsort. With ``seq_len < W`` the slots
    past ``seq_len`` are empty (slot_pos -1); the reference instead returns
    the prefill cache unpadded there (see ROADMAP C)."""
    if window is None:
        return kv
    k, v = kv["k"], kv["v"]
    W = window
    if seq_len < W:
        B, _, K, hd = k.shape
        ring = {"k": k.new_zeros(B, W, K, hd), "v": v.new_zeros(B, W, K, hd),
                "slot_pos": torch.full((W,), -1, dtype=torch.int32, device=k.device)}
        ring["k"][:, :seq_len] = k[:, :seq_len]
        ring["v"][:, :seq_len] = v[:, :seq_len]
        ring["slot_pos"][:seq_len] = torch.arange(seq_len, dtype=torch.int32, device=k.device)
        return ring
    abs_pos = torch.arange(seq_len - W, seq_len, dtype=torch.int32, device=k.device)
    order = torch.argsort(abs_pos % W)
    return {"k": k[:, seq_len - W:seq_len][:, order].contiguous(),
            "v": v[:, seq_len - W:seq_len][:, order].contiguous(),
            "slot_pos": abs_pos[order]}


# -- paged KV pool ---------------------------------------------------------------
#
# A layer's pool is {k, v: (P + 1, page_size, K, hd)}, plus for int8
# {k_scale, v_scale: (P + 1, page_size, K, 1) float32}. Pages 0..P-1 are the
# reference's pool; the one page past them takes every write the reference
# drops (``mode="drop"``: padding rows, masked uncond shares, positions a
# short prompt's table does not cover), so a dropped write never lands on a
# real page and no write needs a host-side mask. Nothing reads it: reads go
# through ``pool_view``, which clamps table entries into [0, P).


def paged_cache_spec(cfg, num_pages: int, page_size: int, *, kv_dtype: str = "bf16",
                     dtype=torch.bfloat16, device=None):
    """One layer's zero pool of ``num_pages`` pages (and the spare page) on
    ``device`` (None: the GPU); int8 pools carry float32 scales."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r} not in ('bf16', 'int8')")
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    device = resolve_device(device)
    shape = (num_pages + 1, page_size, K, hd)
    vdt = torch.int8 if kv_dtype == "int8" else dtype
    pool = {"k": torch.zeros(shape, dtype=vdt, device=device),
            "v": torch.zeros(shape, dtype=vdt, device=device)}
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            pool[name] = torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
    return pool


def pool_view(pool):
    """The layer's P real pages, without the spare: {name: (P, ...)} views."""
    return {name: t[:-1] for name, t in pool.items()}


def _spare(pages, num_pages: int):
    """Destination pages with every entry outside [0, P) sent to the spare."""
    return torch.where((pages < 0) | (pages >= num_pages), num_pages, pages)


def _pool_put(pool, pages, offs, name: str, vals):
    """Write ``vals`` (n, K, hd) at (pages, offs), quantizing for int8."""
    if "k_scale" in pool:
        vals, scales = quantize_kv(vals)
        pool[name + "_scale"][pages, offs] = scales
    pool[name][pages, offs] = vals.to(pool[name].dtype)


def attn_decode_paged(p, cfg, x, pool, block_table, pos, rope, *, window=None, phase=None):
    """One token per row vs the shared paged pool. x (B,1,D); block_table
    (B, nb) int32, entries >= P are padding; pos (B,) int32 per-row
    positions, ``rope`` from them; ``phase`` (B,) int32 marks a ragged pass
    list, rows at phase 0 give zeros. The new K/V is written (in place) at
    each row's position before attention, quantized for int8 pools.
    -> (out (B,1,D), pool)."""
    P, ps = pool["k"].shape[0] - 1, pool["k"].shape[1]
    nb = block_table.shape[1]
    q, k_new, v_new = _qkv(p, cfg, x, rope)
    col = (pos // ps).long()
    wpage = block_table.gather(1, col.clamp(max=nb - 1)[:, None])[:, 0].long()
    wpage = _spare(torch.where(col < nb, wpage, P), P)
    woff = (pos % ps).long()
    _pool_put(pool, wpage, woff, "k", k_new[:, 0])
    _pool_put(pool, wpage, woff, "v", v_new[:, 0])
    view = pool_view(pool)
    if "k_scale" in pool:
        kv = (view["k"], view["k_scale"], view["v"], view["v_scale"])
        if phase is None:
            ctx = KP.paged_decode_attention_int8(q[:, 0], *kv, block_table, pos, window=window)
        else:
            ctx = KP.ragged_paged_decode_attention_int8(q[:, 0], *kv, block_table, pos, phase,
                                                        window=window)
    elif phase is None:
        ctx = KP.paged_decode_attention(q[:, 0], view["k"], view["v"], block_table, pos,
                                        window=window)
    else:
        ctx = KP.ragged_paged_decode_attention(q[:, 0], view["k"], view["v"], block_table, pos,
                                               phase, window=window)
    return _out_proj(p, ctx[:, None]), pool


def paged_scatter_prefill(pool, cache, pages, offs):
    """Write one layer's batched prefill KV, cache {k, v} (kb, Sb, K, hd),
    into its pool at the flattened (kb*Sb,) destinations ``pages``,
    ``offs``; pages outside [0, P) drop (to the spare page). int8 pools
    quantize on write. -> pool (updated in place)."""
    P = pool["k"].shape[0] - 1
    pages = _spare(pages.long(), P)
    offs = offs.long()
    for name in ("k", "v"):
        c = cache[name]
        _pool_put(pool, pages, offs, name, c.reshape(-1, *c.shape[2:]))
    return pool
