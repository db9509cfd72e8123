"""Mixture-of-Experts: top-k router, sort-based capacity dispatch, the
load-balance aux loss and shared experts. Counterpart of
``repro/models/moe.py``.

Each batch row is a routing group with its own capacity C (the reference's
vmapped ``_dispatch_group``). A group's (token, choice) pairs are sorted by
expert with a stable sort, so that within an expert tokens keep their
order, and the pairs past an expert's C slots are dropped in that order.
The experts run on the (B, E, C, D) buffer with batched matmuls, as the
reference's einsums do.

The dispatch and the combine are gathers, not scatters: the buffer slot
(e, c) reads the token the sorted list puts there, and a token reads back
its k slots. So no two writes meet, and a step gives the same bits every
time it runs (eager or replayed as a CUDA graph). Every shape comes from
(B, S, E, k, C), and nothing is read on the host: a decode step that holds
a MoE layer can be captured.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_moe(cfg, mk):
    m = cfg.moe
    D = cfg.d_model
    E, Fd = m.num_experts, m.expert_d_ff
    p = {
        "router": mk((D, E), ("embed", "experts"), scale=1 / math.sqrt(D)),
        "w_gate": mk((E, D, Fd), ("experts", "expert_embed", "mlp"), scale=1 / math.sqrt(D)),
        "w_up": mk((E, D, Fd), ("experts", "expert_embed", "mlp"), scale=1 / math.sqrt(D)),
        "w_down": mk((E, Fd, D), ("experts", "mlp", "expert_embed"), scale=1 / math.sqrt(Fd)),
    }
    if m.num_shared_experts:
        p["shared"] = L.init_swiglu(mk, D, m.shared_d_ff or m.expert_d_ff)
    return p


def _capacity(num_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(m.top_k, min(num_tokens, (c + 7) // 8 * 8))


class Routing(NamedTuple):
    """One layer's routing of x (B, S, D): per (token, choice) the expert
    ``ids`` (B, S, k), the renormalised ``gates`` (B, S, k) float32, ``keep``
    (B, S, k) bool (False: dropped over capacity) and ``slot`` (B, S, k), the
    pair's row e * C + c of the expert buffer; per buffer slot (B, E*C) the
    ``token`` it holds and ``filled``; the router's ``probs`` (B, S, E)."""
    ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    token: torch.Tensor
    filled: torch.Tensor
    probs: torch.Tensor


def route(p, cfg, x, C: int) -> Routing:
    """Top-k routing and the sort-based capacity dispatch of every group."""
    m = cfg.moe
    B, S, _ = x.shape
    E, k = m.num_experts, m.top_k
    dev = x.device
    logits = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower expert first among equals
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]                              # (B,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_ids = ids.reshape(B, S * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)                   # (B,S*k)
    s_ids = flat_ids.gather(1, order)
    counts = torch.zeros(B, E, dtype=torch.long, device=dev).scatter_add_(
        1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=1) - counts                          # exclusive
    pos_in_e = torch.arange(S * k, device=dev) - starts.gather(1, s_ids)
    # the sorted pair at ``order[j]``'s place -> the flat pair's own entry
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * k, device=dev).expand(B, S * k))
    pos_flat = pos_in_e.gather(1, inv)
    keep = pos_flat < C
    slot = flat_ids * C + torch.clamp(pos_flat, max=C - 1)

    # buffer slot (e, c) holds sorted pair starts[e] + c when c < counts[e]
    c_ar = torch.arange(C, device=dev)
    src = starts[:, :, None] + c_ar                                        # (B,E,C)
    filled = c_ar < counts[:, :, None]
    src = torch.clamp(src, max=S * k - 1).reshape(B, E * C)
    token = order.gather(1, src) // k
    return Routing(ids, gates, keep.reshape(B, S, k), slot.reshape(B, S, k), token,
                   filled.reshape(B, E * C), probs)


def aux_loss(cfg, r: Routing):
    """The Switch load-balance term: router_aux_weight * E * sum over experts
    of (mean router probability) x (share of first choices), each averaged
    over the groups."""
    m = cfg.moe
    B, S, E = r.probs.shape
    me = r.probs.mean(dim=1)                                               # (B,E)
    first = r.ids[..., 0]
    ce = torch.zeros(B, E, dtype=torch.float32, device=first.device).scatter_add_(
        1, first, torch.ones(B, S, dtype=torch.float32, device=first.device)) / S
    return m.router_aux_weight * E * torch.sum(me.mean(0) * ce.mean(0))


def moe_forward(p, cfg, x):
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar float32)."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    C = _capacity(S, cfg)
    dt = x.dtype
    r = route(p, cfg, x, C)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.where(r.filled[..., None], x[rows, r.token], 0.0)
    buf = buf.reshape(B, E, C, D)

    g = torch.einsum("becd,edf->becf", buf, p.w_gate.to(dt))
    u = torch.einsum("becd,edf->becf", buf, p.w_up.to(dt))
    h = F.silu(g.float()).to(dt) * u
    y = torch.einsum("becf,efd->becd", h, p.w_down.to(dt)).reshape(B, E * C, D)

    k = m.top_k
    got = y[rows, r.slot.reshape(B, S * k)].reshape(B, S, k, D)
    got = torch.where(r.keep[..., None], got, 0.0) * r.gates[..., None].to(dt)
    out = got.sum(dim=2)
    if m.num_shared_experts:
        out = out + L.swiglu(p.shared, x.reshape(B * S, D)).reshape(B, S, D)
    return out, aux_loss(cfg, r)
