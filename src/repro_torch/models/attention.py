"""GQA attention: RoPE, qk-norm, sliding windows, linear and ring decode
caches. Counterpart of ``repro.models.attention``.

* ``attn_forward``       the direct O(S^2)-scores path, positions given (the
                         SD text encoder's path);
* ``attn_forward_auto``  prefill at positions ``arange(S)``: the flash
                         kernel for CUDA tensors at every S, its plain
                         version (the same math as ``attn_forward``) on the
                         CPU;
* ``attn_decode``        one token vs a linear cache, written in place, then
                         the flash-decode kernel (CUDA) or its plain version,
                         at a position on the device (``decode_pos``), one
                         for the batch or one a row (a slot arena's rows,
                         read and written in place);
* ``attn_decode_ring``   one token vs a ring buffer of ``window`` slots,
                         written in place, then the flash-decode kernel's
                         ring form (CUDA) or its plain version; a position
                         and a ring a row in a windowed slot arena;
* ``attn_decode_paged``  one token per row vs the shared paged KV pool
                         through block tables, per-row positions, then the
                         paged/ragged decode kernels (CUDA) or their plain
                         version; ``paged_scatter_prefill`` writes a
                         batched prefill's KV into the pool.

On a mesh of several devices (a ``MeshShard``: the serve engine's pools
split over ranks, one process a device) ``attn_decode`` and
``attn_decode_paged`` run on this rank's share. A paged pool's pages split
over ``data``: the global block table is translated to local page ids, a
write to another rank's page lands on the local spare, the kernels' shard
form attends the local keys and the ranks' (o, lse) are gathered and merged
(``dist.exchange``). A slot pool's rows split the same way, each row on
one rank. Kv heads split over ``model``: a rank attends its kv heads and
their query heads, then gathers every head and runs the whole
o-projection itself, in the meshless sum order.

The decoder paths take RoPE tables (``layers.rope_tables``) that the stack
computes once per forward. Grouped-head products never replicate KV.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.dist import exchange as X
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import paged_decode_attention as KP
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from repro_torch.models import layers as L


def init_attention(cfg, mk):
    D, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": mk((D, H, hd), ("embed", "heads", "head_dim"), scale=1 / math.sqrt(D)),
        "wk": mk((D, K, hd), ("embed", "kv_heads", "head_dim"), scale=1 / math.sqrt(D)),
        "wv": mk((D, K, hd), ("embed", "kv_heads", "head_dim"), scale=1 / math.sqrt(D)),
        "wo": mk((H, hd, D), ("heads", "head_dim", "embed"), scale=1 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), ("head_dim",), init="ones")
        p["k_norm"] = mk((hd,), ("head_dim",), init="ones")
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


class DecodePos(NamedTuple):
    """A decode step's position on the device: ``pos`` (1,) int32, which
    the flash-decode kernel reads, and ``index`` (1,) int64, where the
    caches are written. Nothing reads it on the host, so a step that takes
    one can be captured once in a CUDA graph and replayed at every
    position. The per-row form (a slot arena's step): ``pos`` and ``index``
    (B,), one position a row, and ``rows`` (B,) int32 with ``row_index``
    (B,) int64, the cache row each batch row reads and writes in place."""
    pos: torch.Tensor
    index: torch.Tensor
    rows: torch.Tensor | None = None
    row_index: torch.Tensor | None = None


def decode_pos(pos, device, rows=None) -> DecodePos:
    """``pos`` (a Python int, a 0-d or one-element int32 tensor, or a
    ``DecodePos``) as a ``DecodePos`` on ``device``; an int is filled in on
    the device (no host-to-device copy). With ``rows``, the (B,) cache rows
    of the batch rows, ``pos`` is a (B,) tensor, a position a row."""
    if isinstance(pos, DecodePos):
        return pos
    if rows is not None:
        pos, rows = pos.reshape(-1).to(torch.int32), rows.reshape(-1).to(torch.int32)
        return DecodePos(pos, pos.long(), rows, rows.long())
    if torch.is_tensor(pos):
        pos = pos.reshape(1).to(torch.int32)
    else:
        pos = torch.full((1,), int(pos), dtype=torch.int32, device=device)
    return DecodePos(pos, pos.long())


def kv_quant() -> bool:
    """``REPRO_KV_QUANT=int8``, read at each call as the reference reads it:
    linear decode caches (not rings, not the paged pool, which has
    ``kv_dtype``) hold int8 values and bf16 scales, one a (position, kv
    head)."""
    return os.environ.get("REPRO_KV_QUANT") == "int8"


def quantize_linear_kv(x):
    """The linear cache's int8 form: bf16 scales and the 1e-6 amax floor,
    the reference's ``REPRO_KV_QUANT`` quantization. -> (values, scales)."""
    return quantize_kv(x, scale_dtype=torch.bfloat16, eps=1e-6)


def quantize_linear_cache(cache: dict) -> dict:
    """{k, v} -> {k, v int8, k_scale, v_scale bf16 (..., 1)}."""
    (kq, ks), (vq, vs) = quantize_linear_kv(cache["k"]), quantize_linear_kv(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


class MeshShard(NamedTuple):
    """One rank's share of a serve pool split over a mesh: ``lead`` the
    split of the pool's leading axis (a paged pool's pages, a slot pool's
    rows), ``lead_local`` the pages or rows this rank holds (its own spare
    past them), ``heads`` the kv heads' split."""
    lead: X.Split
    lead_local: int
    heads: X.Split

    def head_range(self, K: int) -> tuple[int, int]:
        """This rank's kv heads [g0, g1) of ``K``."""
        n = K // self.heads.n
        return self.heads.index * n, (self.heads.index + 1) * n

    def first(self) -> int:
        """The global id of this rank's first page or row."""
        return self.lead.index * self.lead_local


def _local_qkv(q, k_new, v_new, shard: MeshShard | None, K: int):
    """The query and new K/V heads of this rank's kv heads, sliced from the
    whole projections: the meshless engine's bits."""
    if shard is None or shard.heads.n == 1:
        return q, k_new, v_new
    g0, g1 = shard.head_range(K)
    rep = q.shape[2] // K
    return q[:, :, g0 * rep:g1 * rep].contiguous(), k_new[:, :, g0:g1], v_new[:, :, g0:g1]


def _merge_lead(o, lse, shard: MeshShard, dtype):
    """The ranks' partials over the leading axis, merged; -> in ``dtype``."""
    o, _ = X.merge_partials(X.all_gather(o, shard.lead), X.all_gather(lse, shard.lead))
    return o.to(dtype)


def _gather_heads(ctx, shard: MeshShard | None):
    """ctx (R, H_local, hd) -> (R, H, hd), every rank's heads in order."""
    if shard is None or shard.heads.n == 1:
        return ctx
    R, _, hd = ctx.shape
    return X.all_gather(ctx, shard.heads).permute(1, 0, 2, 3).reshape(R, -1, hd)


def _cache_put(cache, name: str, dp: DecodePos, new) -> None:
    """Write ``new`` (B,1,...) at the step's position, in place: for every
    batch row, or at each row's own cache row and position."""
    if dp.rows is None:
        cache[name].index_copy_(1, dp.index, new)
    else:
        cache[name].index_put_((dp.row_index, dp.index), new[:, 0])


def attn_decode(p, cfg, x, cache, pos, rope, *, window=None, shard: MeshShard | None = None):
    """One token at ``pos`` (see ``decode_pos``) vs a linear cache {k, v}
    (B,S,K,hd), or (N,S,K,hd) read through per-row cache rows. Writes the new K/V
    at ``pos`` in place by a device index (the reference updates
    functionally), then attends to keys ``<= pos`` (and inside
    ``window``). An int8 cache (``kv_quant``: {k, v int8, k_scale,
    v_scale}) is written quantized, then read dequantized to x's dtype, as
    the reference does; the flash-decode kernel runs on that copy. With
    ``shard`` (per-row form) the cache is this rank's rows and kv heads:
    a row another rank holds reads and writes the local spare row and its
    partial is dropped at the merge. x (B,1,D) -> (out (B,1,D), cache)."""
    dp = decode_pos(pos, x.device)
    q, k_new, v_new = _local_qkv(*_qkv(p, cfg, x, rope), shard, cfg.num_kv_heads)
    mine = None
    if shard is not None and shard.lead.n > 1:
        n, first = shard.lead_local, shard.first()
        mine = (dp.rows >= first) & (dp.rows < first + n)
        rows = torch.where(mine, dp.rows - first, n)
        dp = DecodePos(dp.pos, dp.index, rows, rows.long())
    if cache["k"].dtype == torch.int8:
        if "k_scale" not in cache:
            raise ValueError("an int8 linear cache needs its k_scale and v_scale leaves "
                             "(REPRO_KV_QUANT=int8 builds them: cache_spec, "
                             "prepare_decode_caches)")
        for name, new in (("k", k_new), ("v", v_new)):
            vals, scales = quantize_linear_kv(new)
            _cache_put(cache, name, dp, vals)
            _cache_put(cache, name + "_scale", dp, scales)
        k = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        _cache_put(cache, "k", dp, k_new)
        _cache_put(cache, "v", dp, v_new)
        k, v = cache["k"], cache["v"]
    ctx = KD.decode_attention(q[:, 0], k, v, dp.pos, window=window, rows=dp.rows)
    if mine is not None:
        lse = torch.where(mine[:, None], 0.0, -math.inf).expand(ctx.shape[:2])
        ctx = _merge_lead(ctx.float(), lse.contiguous(), shard, ctx.dtype)
    return _out_proj(p, _gather_heads(ctx, shard)[:, None]), cache


def attn_decode_ring(p, cfg, x, cache, pos, rope, *, window: int):
    """One token vs a ring buffer {k, v (B,W,K,hd), slot_pos (W,) int32
    absolute positions, -1 = empty}, updated in place at slot pos % W,
    computed on the device. In the per-row form (``decode_pos`` with rows:
    a windowed slot arena) every cache row is a ring of its own, {k, v
    (N,W,K,hd), slot_pos (N,W)}, and batch row b writes slot pos[b] % W of
    ring row rows[b] and attends over that ring."""
    dp = decode_pos(pos, x.device)
    W = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, cfg, x, rope)
    slot = dp.index % W
    if dp.rows is None:
        cache["k"].index_copy_(1, slot, k_new)
        cache["v"].index_copy_(1, slot, v_new)
        cache["slot_pos"].index_copy_(0, slot, dp.pos)
    else:
        at = (dp.row_index, slot)
        cache["k"].index_put_(at, k_new[:, 0])
        cache["v"].index_put_(at, v_new[:, 0])
        cache["slot_pos"].index_put_(at, dp.pos)
    ctx = KD.decode_attention(q[:, 0], cache["k"], cache["v"], dp.pos, window=window,
                              slot_pos=cache["slot_pos"], rows=dp.rows)
    return _out_proj(p, ctx[:, None]), cache


KV_AXES = ("batch", "kv_seq", "kv_heads", "head_dim")
KV_SCALE_AXES = ("batch", "kv_seq", "kv_heads", None)


def cache_spec(cfg, batch: int, capacity: int, *, ring: bool = False,
               dtype=torch.bfloat16, device=None):
    """A zero decode cache {k, v (batch, capacity, K, hd)} on ``device``
    (None: the GPU): linear, and under ``kv_quant`` int8 with bf16
    {k_scale, v_scale (batch, capacity, K, 1)}; or with ``ring`` a ring of
    ``capacity`` slots, never quantized, with slot_pos (capacity,) int32,
    all -1 (empty)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    device = resolve_device(device)
    quant = kv_quant() and not ring
    vdt = torch.int8 if quant else dtype
    out = {"k": torch.zeros(batch, capacity, K, hd, dtype=vdt, device=device),
           "v": torch.zeros(batch, capacity, K, hd, dtype=vdt, device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            out[name] = torch.zeros(batch, capacity, K, 1, dtype=torch.bfloat16, device=device)
    if ring:
        out["slot_pos"] = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    return out


def cache_axes(*, ring: bool = False) -> dict:
    """The logical axes of ``cache_spec``'s leaves (the reference's
    ``cache_spec`` under an ``AxesMaker``), the knob read as there."""
    out = {"k": KV_AXES, "v": KV_AXES}
    if kv_quant() and not ring:
        out.update(k_scale=KV_SCALE_AXES, v_scale=KV_SCALE_AXES)
    if ring:
        out["slot_pos"] = ("kv_seq",)
    return out


def ring_pool_spec(cfg, rows: int, window: int, *, dtype=torch.bfloat16, device=None):
    """``rows`` empty rings of ``window`` slots, one a slot arena row:
    {k, v (rows, window, K, hd), slot_pos (rows, window) int32, all -1}."""
    pool = cache_spec(cfg, rows, window, ring=True, dtype=dtype, device=device)
    pool["slot_pos"] = torch.full((rows, window), -1, dtype=torch.int32,
                                  device=pool["k"].device)
    return pool


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
# through ``pool_view``, which clamps table entries into [0, P). A rank's
# share of a pool split over a mesh has its own spare past its P_local
# pages, which takes the writes to every other rank's pages too.


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


PAGED_AXES = ("pages", "page", "kv_heads", "head_dim")


def paged_cache_axes(*, kv_dtype: str = "bf16") -> dict:
    """The logical axes of ``paged_cache_spec``'s leaves: the scale leaves
    carry the values' ``pages``/``page`` names, so a page's values and
    scales shard alike."""
    out = {"k": PAGED_AXES, "v": PAGED_AXES}
    if kv_dtype == "int8":
        out.update(k_scale=PAGED_AXES[:3] + (None,), v_scale=PAGED_AXES[:3] + (None,))
    return out


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


def attn_decode_paged(p, cfg, x, pool, block_table, pos, rope, *, window=None, phase=None,
                      shard: MeshShard | None = None):
    """One token per row vs the shared paged pool. x (B,1,D); block_table
    (B, nb) int32, entries >= P are padding; pos (B,) int32 per-row
    positions, ``rope`` from them; ``phase`` (B,) int32 marks a ragged pass
    list, rows at phase 0 give zeros. The new K/V is written (in place) at
    each row's position before attention, quantized for int8 pools. With
    ``shard`` the pool is this rank's pages and kv heads (the table stays
    global). -> (out (B,1,D), pool)."""
    P, ps = pool["k"].shape[0] - 1, pool["k"].shape[1]
    nb = block_table.shape[1]
    q, k_new, v_new = _local_qkv(*_qkv(p, cfg, x, rope), shard, cfg.num_kv_heads)
    first = 0 if shard is None else shard.first()
    col = (pos // ps).long()
    wpage = block_table.gather(1, col.clamp(max=nb - 1)[:, None])[:, 0].long() - first
    wpage = _spare(torch.where(col < nb, wpage, P), P)
    woff = (pos % ps).long()
    _pool_put(pool, wpage, woff, "k", k_new[:, 0])
    _pool_put(pool, wpage, woff, "v", v_new[:, 0])
    view = pool_view(pool)
    if shard is not None and shard.lead.n > 1:
        local = KP.local_table(block_table, first, P)
        scales = dict(k_scales=view["k_scale"], v_scales=view["v_scale"]) \
            if "k_scale" in pool else {}
        o, lse = KP.paged_decode_attention_shard(q[:, 0], view["k"], view["v"], local, pos,
                                                 phase=phase, window=window, **scales)
        ctx = _merge_lead(o, lse, shard, q.dtype)
    elif "k_scale" in pool:
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
    return _out_proj(p, _gather_heads(ctx, shard)[:, None]), pool


def paged_scatter_prefill(pool, cache, pages, offs, shard: MeshShard | None = None):
    """Write one layer's batched prefill KV, cache {k, v} (kb, Sb, K, hd),
    into its pool at the flattened (kb*Sb,) destinations ``pages``,
    ``offs``; pages outside [0, P) drop (to the spare page). int8 pools
    quantize on write. With ``shard``: global pages into this rank's share,
    its kv heads; another rank's pages drop. -> pool (updated in place)."""
    P = pool["k"].shape[0] - 1
    pages = _spare(pages.long() - (0 if shard is None else shard.first()), P)
    offs = offs.long()
    for name in ("k", "v"):
        c = cache[name]
        if shard is not None and shard.heads.n > 1:
            g0, g1 = shard.head_range(c.shape[2])
            c = c[:, :, g0:g1]
        _pool_put(pool, pages, offs, name, c.reshape(-1, *c.shape[2:]))
    return pool
