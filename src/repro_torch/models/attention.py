"""GQA attention, the direct path only. Counterpart of the parameter shapes
of ``repro.models.attention.init_attention`` and of ``attn_forward``."""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


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
    B, S, H, hd = q.shape
    K = cfg.num_kv_heads
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float() / math.sqrt(hd)
    if causal or window is not None:
        qpos = positions[:, None, None, :, None]
        kpos = positions[:, None, None, None, :]
        mask = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bkrqs,bskh->bqkrh", w, v).reshape(B, S, H, hd)
    return torch.einsum("bqhk,hkd->bqd", ctx, p.wo.to(dt))
