"""Multi-head Latent Attention (DeepSeek-V2): the compressed KV cache.
Counterpart of ``repro/models/mla.py``.

The cache holds the normalised latent c_kv (kv_lora_rank) and the shared
RoPE key (qk_rope_head_dim) a position. Prefill decompresses the latents
(``mla_forward``, or ``mla_forward_blocked`` by query chunks on long
prompts); decode is the absorbed form (``mla_decode``): q_nope goes through
W_uk so that attention runs against the latents themselves, and the context
is expanded through W_uv afterwards. Attention is plain matmul and softmax,
as the reference writes it; ``kv_norm`` goes through the RMSNorm kernel
wrapper. The RoPE tables (``layers.rope_tables`` at qk_rope_head_dim) come
from the stack.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_mla(cfg, mk):
    a = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim, a.kv_lora_rank
    s = 1 / math.sqrt(D)
    return {
        "wq": mk((D, H, dn + dr), ("embed", "heads", "head_dim"), scale=s),
        "w_dkv": mk((D, r + dr), ("embed", "kv_lora"), scale=s),
        "kv_norm": mk((r,), ("kv_lora",), init="ones"),
        "w_uk": mk((r, H, dn), ("kv_lora", "heads", "head_dim"), scale=1 / math.sqrt(r)),
        "w_uv": mk((r, H, dv), ("kv_lora", "heads", "head_dim"), scale=1 / math.sqrt(r)),
        "wo": mk((H, dv, D), ("heads", "head_dim", "embed"), scale=1 / math.sqrt(H * dv)),
    }


def _compress(p, cfg, x, rope):
    """-> (c_kv (B,S,r) normalised latent, k_rope (B,S,dr) roped shared key)."""
    r = cfg.mla.kv_lora_rank
    ckv = x @ p.w_dkv.to(x.dtype)                                   # (B,S,r+dr)
    c = L.rmsnorm(p.kv_norm, ckv[..., :r].contiguous())
    k_r = L.apply_rope_tables(ckv[..., r:][:, :, None, :], *rope)[:, :, 0, :]
    return c, k_r


def _queries(p, cfg, x, rope):
    dn = cfg.mla.qk_nope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    return q[..., :dn], L.apply_rope_tables(q[..., dn:], *rope)


def _scale(cfg) -> float:
    return 1 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def _expand(p, c):
    """Latents (B,S,r) -> per-head keys k_nope and values (B,S,H,*)."""
    k_n = torch.einsum("bsr,rhk->bshk", c, p.w_uk.to(c.dtype))
    v = torch.einsum("bsr,rhk->bshk", c, p.w_uv.to(c.dtype))
    return k_n, v


def _attend(cfg, q_n, q_r, k_n, k_r, v, q0: int, causal: bool):
    """Queries at positions q0 .. q0 + Q - 1 against keys 0 .. S - 1."""
    scores = (torch.einsum("bqhk,bshk->bhqs", q_n, k_n)
              + torch.einsum("bqhk,bsk->bhqs", q_r, k_r)).float() * _scale(cfg)
    if causal:
        Q, S = q_n.shape[1], k_n.shape[1]
        qp = torch.arange(q0, q0 + Q, device=q_n.device)[:, None]
        scores = torch.where(torch.arange(S, device=q_n.device)[None] <= qp, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q_n.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def mla_forward(p, cfg, x, rope, *, causal: bool = True):
    """Naive (decompressed) prefill at positions ``arange(S)``. -> (out,
    cache {c, k_rope})."""
    q_n, q_r = _queries(p, cfg, x, rope)
    c, k_r = _compress(p, cfg, x, rope)
    k_n, v = _expand(p, c)
    ctx = _attend(cfg, q_n, q_r, k_n, k_r, v, 0, causal)
    out = torch.einsum("bqhk,hkd->bqd", ctx, p.wo.to(x.dtype))
    return out, {"c": c, "k_rope": k_r}


def mla_forward_blocked(p, cfg, x, rope, *, causal: bool = True, q_chunk: int = 512):
    """Prefill by query chunks of ``q_chunk`` for long sequences: a chunk's
    scores (B,H,q_chunk,S) never outlive it, and under autograd each chunk
    is recomputed in the backward (the reference's ``jax.checkpoint``).
    Keys and values decompress once."""
    S = x.shape[1]
    if S % q_chunk:
        raise ValueError(f"S {S} is not a multiple of q_chunk {q_chunk}")
    q_n, q_r = _queries(p, cfg, x, rope)
    c, k_r = _compress(p, cfg, x, rope)
    k_n, v = _expand(p, c)
    grad = torch.is_grad_enabled()
    chunks = []
    for q0 in range(0, S, q_chunk):
        args = (cfg, q_n[:, q0:q0 + q_chunk], q_r[:, q0:q0 + q_chunk], k_n, k_r, v, q0, causal)
        chunks.append(checkpoint(_attend, *args, use_reentrant=False) if grad
                      else _attend(*args))
    out = torch.einsum("bqhk,hkd->bqd", torch.cat(chunks, dim=1), p.wo.to(x.dtype))
    return out, {"c": c, "k_rope": k_r}


def mla_decode(p, cfg, x, cache, pos, rope):
    """Absorbed decode of one token at ``pos`` (``attention.decode_pos``)
    against the latent cache {c (B,S,r), k_rope (B,S,dr)}: the new latent
    and key are written in place at the device position, then attention
    runs over positions ``<= pos`` (a mask built on the device). In the
    per-row form (``decode_pos`` with rows: a slot arena) the cache is a
    pool {c (N,S,r), k_rope (N,S,dr)}, and batch row b writes position
    pos[b] of pool row rows[b] and attends over that row to pos[b]. x
    (B,1,D) -> (out (B,1,D), cache)."""
    dp = A.decode_pos(pos, x.device)
    dt = x.dtype
    q_n, q_r = _queries(p, cfg, x, rope)
    c_new, kr_new = _compress(p, cfg, x, rope)
    c, k_r = cache["c"], cache["k_rope"]
    S = c.shape[1]
    if dp.rows is None:
        c.index_copy_(1, dp.index, c_new.to(c.dtype))
        k_r.index_copy_(1, dp.index, kr_new.to(k_r.dtype))
        valid = torch.arange(S, device=c.device) <= dp.pos
    else:
        at = (dp.row_index, dp.index)
        c.index_put_(at, c_new[:, 0].to(c.dtype))
        k_r.index_put_(at, kr_new[:, 0].to(k_r.dtype))
        c, k_r = c.index_select(0, dp.row_index), k_r.index_select(0, dp.row_index)
        valid = (torch.arange(S, device=c.device) <= dp.pos[:, None])[:, None, None, :]
    q_abs = torch.einsum("bqhk,rhk->bqhr", q_n, p.w_uk.to(dt))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, c)
              + torch.einsum("bqhk,bsk->bhqs", q_r, k_r)).float() * _scale(cfg)
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", w, c)
    ctx = torch.einsum("bqhr,rhk->bqhk", ctx_lat, p.w_uv.to(dt))
    return torch.einsum("bqhk,hkd->bqd", ctx, p.wo.to(dt)), cache


def mla_cache_axes() -> dict:
    return {"c": ("batch", "kv_seq", "kv_lora"), "k_rope": ("batch", "kv_seq", "head_dim")}


def mla_cache_spec(cfg, batch: int, capacity: int, *, dtype=torch.bfloat16, device=None):
    """A zero latent cache {c (batch, capacity, r), k_rope (batch, capacity,
    dr)}: r + dr numbers a position, for all heads."""
    a, device = cfg.mla, resolve_device(device)
    return {"c": torch.zeros(batch, capacity, a.kv_lora_rank, dtype=dtype, device=device),
            "k_rope": torch.zeros(batch, capacity, a.qk_rope_head_dim, dtype=dtype,
                                  device=device)}
