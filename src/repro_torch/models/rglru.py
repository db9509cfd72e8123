"""RG-LRU recurrent block (Griffin / RecurrentGemma). Counterpart of
``repro/models/rglru.py``.

Block: x -> {linear -> causal conv1d(4) -> RG-LRU} * gelu(linear) -> linear,
with the diagonal recurrence per channel

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    a_t = exp(-c softplus(Lambda) r_t)  in (0, 1),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

Prefill solves the linear recurrence h_t = a_t h_{t-1} + b_t with a
Hillis-Steele doubling scan in float32 (log2 S passes of
``b[t] += a[t] b[t-d]; a[t] *= a[t-d]``), the counterpart of the
reference's ``associative_scan``; it multiplies decays and never takes
``exp`` of a summed log, which underflows on long prompts. Decode updates
the state {conv (B,3,W), h (B,W) float32} in place, or a slot arena's rows
of it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L

C_SCALE = 8.0
CONV_W = 4


def init_rglru(cfg, mk):
    D = cfg.d_model
    W = D  # lru width = d_model
    s = 1 / math.sqrt(D)
    return {
        "w_in": mk((D, W), ("embed", "mlp"), scale=s),          # recurrent branch
        "w_gate_br": mk((D, W), ("embed", "mlp"), scale=s),     # gelu gate branch
        "conv_w": mk((CONV_W, W), ("time", "mlp"), scale=1 / math.sqrt(CONV_W)),
        "conv_b": mk((W,), ("mlp",), init="zeros"),
        "w_a": mk((W, W), ("mlp", "state"), scale=1 / math.sqrt(W)),
        "b_a": mk((W,), ("state",), init="zeros"),
        "w_x": mk((W, W), ("mlp", "state"), scale=1 / math.sqrt(W)),
        "b_x": mk((W,), ("state",), init="zeros"),
        "lam": mk((W,), ("state",), init="ones"),               # softplus -> decay
        "w_out": mk((W, D), ("mlp", "embed"), scale=1 / math.sqrt(W)),
    }


def _gates(p, u):
    """u (..., W) conv output -> (a, b) float32 of the linear recurrence."""
    r = torch.sigmoid((u @ p.w_a.to(u.dtype)).float() + p.b_a.float())
    i = torch.sigmoid((u @ p.w_x.to(u.dtype)).float() + p.b_x.float())
    log_a = -C_SCALE * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    return a, b


def _conv_full(p, x):
    """Causal temporal conv of width 4 over x (B,S,W), in x's dtype."""
    S = x.shape[1]
    pads = F.pad(x, (0, 0, CONV_W - 1, 0))
    out = sum(pads[:, j:j + S] * p.conv_w[j].to(x.dtype) for j in range(CONV_W))
    return out + p.conv_b.to(x.dtype)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along axis 1 of a, b (B,S,W),
    by doubling: after the pass at distance d, entry t holds the combination
    of steps t - 2d + 1 .. t."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p, cfg, x):
    """x (B,S,D) -> (out (B,S,D), state {conv (B,3,W), h (B,W) float32})."""
    u0 = x @ p.w_in.to(x.dtype)                                     # (B,S,W)
    u = _conv_full(p, u0)
    a, b = _gates(p, u)
    h = linear_scan(a, b)
    gate = F.gelu((x @ p.w_gate_br.to(x.dtype)).float(), approximate="tanh")
    out = (h * gate).to(x.dtype) @ p.w_out.to(x.dtype)
    return out, {"conv": u0[:, -(CONV_W - 1):, :].clone(), "h": h[:, -1, :].clone()}


def rglru_decode(p, cfg, x, state, rows=None):
    """x (B,1,D) and state {conv, h}, updated in place -> (out (B,1,D),
    state). With ``rows`` (B,) int64, ``state`` is a slot arena's pool and
    batch row b steps pool row rows[b] (``layers.state_rows``)."""
    dt = x.dtype
    cur = L.state_rows(state, rows)
    u0 = x[:, 0] @ p.w_in.to(dt)                                    # (B,W)
    hist = torch.cat([cur["conv"], u0[:, None, :].to(cur["conv"].dtype)], dim=1)
    u = torch.einsum("btw,tw->bw", hist.to(dt), p.conv_w.to(dt)) + p.conv_b.to(dt)
    a, b = _gates(p, u)
    h = a * cur["h"] + b
    gate = F.gelu((x[:, 0] @ p.w_gate_br.to(dt)).float(), approximate="tanh")
    out = (h * gate).to(dt) @ p.w_out.to(dt)
    L.put_state(state, {"conv": hist[:, 1:], "h": h}, rows)
    return out[:, None, :], state


def rglru_state_axes() -> dict:
    return {"conv": ("batch", "time", "state"), "h": ("batch", "state")}


def rglru_state_spec(cfg, batch: int, *, dtype=torch.bfloat16, device=None):
    W, device = cfg.d_model, resolve_device(device)
    return {"conv": torch.zeros(batch, CONV_W - 1, W, dtype=dtype, device=device),
            "h": torch.zeros(batch, W, dtype=torch.float32, device=device)}
