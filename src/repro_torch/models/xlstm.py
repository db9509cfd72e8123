"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).
Counterpart of ``repro/models/xlstm.py`` (arXiv:2405.04517).

mLSTM: q, k, v from an up-projected stream; exponential input gate i~,
log-sigmoid forget gate f~ and the stabiliser m:

    m_t = max(f~_t + m_{t-1}, i~_t)
    C_t = exp(f~_t + m_{t-1} - m_t) C_{t-1} + exp(i~_t - m_t) v_t k_t^T
    n_t = exp(f~_t + m_{t-1} - m_t) n_{t-1} + exp(i~_t - m_t) k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

then a SiLU-gated down-projection. sLSTM: a scalar memory a channel with
the same exponential gating and a normaliser, its recurrent weights
block-diagonal over ``num_heads``, then a GELU MLP.

Prefill is a loop over time (the reference's ``lax.scan``), the state in
float32. On the GPU without autograd, a performance path: after two eager
steps one step is captured as a CUDA graph that reads its inputs at a step
counter on the device and writes the state and its output in place, and
the loop replays it: the same kernels on the same values, without the
host's cost of some twenty launches a step
(``tests/test_torch_recurrent.py`` holds its control flow to the loop
through an eager stand-in for the capture). Under autograd a sequence
longer than ``bptt_chunk`` (``REPRO_BPTT_CHUNK``, 64 by default) that it
divides runs chunk by chunk under
``torch.utils.checkpoint``: the backward keeps the state at chunk
boundaries only and recomputes within a chunk (the reference's chunked
BPTT). sLSTM's input projections run once for the whole sequence before
the loop, and its four recurrent products as one. Decode updates the state
dicts in place (or, with ``rows``, a slot arena's rows of its pools):
mLSTM {C (B,H,dh,dh), n (B,H,dh), m (B,H)}, sLSTM {c, n,
m, h (B,D)}, all float32.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L

PROJ_FACTOR = 2    # d_inner = 2 * d_model (the paper's mLSTM proj factor)
BPTT_CHUNK = 64    # ~sqrt(4096): state saves at chunk edges against saves within a chunk


def bptt_chunk_default() -> int:
    """``REPRO_BPTT_CHUNK``, read at each call as the reference reads it:
    the chunk of the backward's recomputation, ``BPTT_CHUNK`` unset, 0 for
    naive BPTT (every step's state kept)."""
    return int(os.environ.get("REPRO_BPTT_CHUNK", str(BPTT_CHUNK)))


def time_scan(step, state: tuple, xs: tuple, *, bptt_chunk: int | None = None):
    """Runs ``state, y = step(state, x_t)`` over axis 1 of the tensors
    ``xs`` (B, S, ...) -> (final state, ys (B, S, ...)). The loop over time
    is the semantics. On CUDA tensors without autograd the loop is replayed
    from one captured step instead (``_replayed_scan``): a performance path
    with the same steps on the same values, which takes a full-width
    prefill from some twenty launches a step to one graph replay (ROADMAP
    B'9). Under autograd, with 0 < bptt_chunk < S and S % bptt_chunk == 0,
    each chunk of steps runs under ``torch.utils.checkpoint`` (``None``:
    ``bptt_chunk_default()``). On meta
    tensors (the dry-run's shapes) one step runs and its output is
    broadcast to S steps: the reference's cost lowering counts a scan body
    once too, and ``launch/steps.recurrent_supplement`` adds the rest."""
    S = xs[0].shape[1]
    if xs[0].is_meta:
        state, y = step(state, tuple(x[:, 0] for x in xs))
        return state, y[:, None].expand((y.shape[0], S) + tuple(y.shape[1:]))
    if xs[0].is_cuda and not torch.is_grad_enabled() and S > 2 \
            and not torch.cuda.is_current_stream_capturing():
        return _replayed_scan(step, state, xs)

    def run(state, lo: int, hi: int):
        ys = []
        for t in range(lo, hi):
            state, y = step(state, tuple(x[:, t] for x in xs))
            ys.append(y)
        return state, torch.stack(ys, dim=1)

    if bptt_chunk is None:
        bptt_chunk = bptt_chunk_default()
    if not torch.is_grad_enabled() or bptt_chunk <= 0 or S <= bptt_chunk or S % bptt_chunk:
        return run(state, 0, S)
    chunks = []
    for lo in range(0, S, bptt_chunk):
        state, ys = checkpoint(run, state, lo, lo + bptt_chunk, use_reentrant=False)
        chunks.append(ys)
    return state, torch.cat(chunks, dim=1)


def _replayed_scan(step, state: tuple, xs: tuple, capture=None):
    """``time_scan`` without autograd, S > 2: step 0 eagerly, then one step
    that gathers its inputs at the device counter ``t``, writes the state
    and its output in place and advances ``t``, which ``capture`` runs once
    (step 1) and returns as a callable replayed for steps 2 .. S - 1.
    ``capture`` defaults to ``_capture_step`` (a CUDA graph); the CPU tests
    pass an eager stand-in."""
    S = xs[0].shape[1]
    state, y0 = step(state, tuple(x[:, 0] for x in xs))
    static = tuple(s.clone() for s in state)
    ys = y0.new_empty((y0.shape[0], S) + tuple(y0.shape[1:]))
    ys[:, 0] = y0
    t = torch.ones(1, dtype=torch.long, device=y0.device)

    def one():
        new, y = step(static, tuple(x.index_select(1, t)[:, 0] for x in xs))
        for s, n in zip(static, new):
            s.copy_(n)
        ys.index_copy_(1, t, y[:, None])
        t.add_(1)

    replay = (capture or _capture_step)(one)
    for _ in range(S - 2):
        replay()
    return static, ys


def _capture_step(one):
    """Runs ``one`` on a side stream, then captures it as a CUDA graph ->
    the graph's replay. ``capture_begin``/``capture_end`` rather than
    ``torch.cuda.graph``, which would empty the allocator's cache at every
    layer's capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        one()
        graph.capture_begin()
        try:
            one()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph.replay


# -- mLSTM ---------------------------------------------------------------------


def init_mlstm(cfg, mk):
    D = cfg.d_model
    Din = PROJ_FACTOR * D
    H = cfg.num_heads
    s, si = 1 / math.sqrt(D), 1 / math.sqrt(Din)
    return {
        "w_up": mk((D, Din), ("embed", "mlp"), scale=s),
        "w_gate": mk((D, Din), ("embed", "mlp"), scale=s),
        "wq": mk((Din, Din), ("mlp", "heads"), scale=si),
        "wk": mk((Din, Din), ("mlp", "heads"), scale=si),
        "wv": mk((Din, Din), ("mlp", "heads"), scale=si),
        "w_i": mk((Din, H), ("mlp", "heads"), scale=si),
        "b_i": mk((H,), ("heads",), init="zeros"),
        "w_f": mk((Din, H), ("mlp", "heads"), scale=si),
        "b_f": mk((H,), ("heads",), init="ones"),
        "w_down": mk((Din, D), ("mlp", "embed"), scale=1 / math.sqrt(Din)),
    }


def _mlstm_qkvif(p, cfg, u):
    """u (..., Din) -> q, k, v (..., H, dh) in u's dtype, i~, f~ (..., H)
    float32 (f~ a log-sigmoid)."""
    H = cfg.num_heads
    dh = u.shape[-1] // H
    lead = u.shape[:-1]
    q = (u @ p.wq.to(u.dtype)).reshape(*lead, H, dh)
    k = (u @ p.wk.to(u.dtype)).reshape(*lead, H, dh) / math.sqrt(dh)
    v = (u @ p.wv.to(u.dtype)).reshape(*lead, H, dh)
    it = (u @ p.w_i.to(u.dtype)).float() + p.b_i.float()
    ft = (u @ p.w_f.to(u.dtype)).float() + p.b_f.float()
    return q, k, v, it, -F.softplus(-ft)


def mlstm_step(state: tuple, qkvif: tuple):
    """One step. state (C, n, m); q, k, v (B,H,dh), i~, f~ (B,H) -> (new
    state, h (B,H,dh) float32)."""
    C, n, m = state
    q, k, v, it, ft = qkvif
    m_new = torch.maximum(ft + m, it)
    fe = torch.exp(ft + m - m_new)[..., None]
    ie = torch.exp(it - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C_new = fe[..., None] * C + ie[..., None] * (vf[..., :, None] * kf[..., None, :])
    n_new = fe * n + ie * kf
    qf = q.float()
    num = (C_new @ qf[..., None])[..., 0]
    den = torch.clamp(torch.abs((n_new * qf).sum(-1))[..., None], min=1.0)
    return (C_new, n_new, m_new), num / den


def _mlstm_out(p, x, h):
    gate = F.silu((x @ p.w_gate.to(x.dtype)).float())
    return (h * gate).to(x.dtype) @ p.w_down.to(x.dtype)


def mlstm_forward(p, cfg, x, *, bptt_chunk: int | None = None):
    """x (B,S,D) -> (out (B,S,D), state {C, n, m})."""
    B, S, _ = x.shape
    H = cfg.num_heads
    u = x @ p.w_up.to(x.dtype)
    dh = u.shape[-1] // H
    f32 = dict(dtype=torch.float32, device=x.device)
    state0 = (torch.zeros(B, H, dh, dh, **f32), torch.zeros(B, H, dh, **f32),
              torch.zeros(B, H, **f32))

    def step(state, xs_t):
        state, h = mlstm_step(state, xs_t)
        return state, h.to(x.dtype)      # the saved (B,S,H,dh) stack in the stream dtype

    (C, n, m), hs = time_scan(step, state0, _mlstm_qkvif(p, cfg, u), bptt_chunk=bptt_chunk)
    return _mlstm_out(p, x, hs.reshape(B, S, -1)), {"C": C, "n": n, "m": m}


def mlstm_decode(p, cfg, x, state, rows=None):
    """x (B,1,D), state {C, n, m} updated in place (with ``rows``, a slot
    arena's pool rows: ``rglru.rglru_decode``) -> (out (B,1,D), state)."""
    cur = L.state_rows(state, rows)
    u = x[:, 0] @ p.w_up.to(x.dtype)
    (C, n, m), h = mlstm_step((cur["C"], cur["n"], cur["m"]), _mlstm_qkvif(p, cfg, u))
    out = _mlstm_out(p, x[:, 0], h.reshape(x.shape[0], -1))
    L.put_state(state, {"C": C, "n": n, "m": m}, rows)
    return out[:, None, :], state


def mlstm_state_axes() -> dict:
    return {"C": ("batch", "heads", "state", "head_dim"), "n": ("batch", "heads", "state"),
            "m": ("batch", "heads")}


def mlstm_state_spec(cfg, batch: int, *, device=None):
    H, device = cfg.num_heads, resolve_device(device)
    dh = PROJ_FACTOR * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, H, dh, dh, **f32), "n": torch.zeros(batch, H, dh, **f32),
            "m": torch.zeros(batch, H, **f32)}


# -- sLSTM ---------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def init_slstm(cfg, mk):
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    s, sh = 1 / math.sqrt(D), 1 / math.sqrt(dh)
    p = {f"w_{g}": mk((D, D), ("embed", "mlp"), scale=s) for g in GATES}   # input projections
    p.update({f"r_{g}": mk((H, dh, dh), ("heads", "state", "head_dim"), scale=sh)
              for g in GATES})                                            # block-diagonal recurrence
    p.update({f"b_{g}": mk((D,), ("mlp",), init="ones" if g == "f" else "zeros")
              for g in GATES})
    p["w_up"] = mk((D, 2 * D), ("embed", "mlp"), scale=s)                  # the block's small MLP
    p["w_down"] = mk((2 * D, D), ("mlp", "embed"), scale=1 / math.sqrt(2 * D))
    return p


def _slstm_inputs(p, x):
    """x (..., D) -> the four gates' input projections (..., 4, D) float32."""
    xf = x.float()
    return torch.stack([xf @ getattr(p, f"w_{g}").float() for g in GATES], dim=-2)


def _slstm_recurrent(p, cfg):
    """The four recurrent weights as one (H, dh, 4 dh) float32 matrix."""
    return torch.cat([getattr(p, f"r_{g}").float() for g in GATES], dim=-1)


def slstm_step(p, cfg, r_all, state: tuple, pre):
    """One step. state (c, n, m, h) each (B,D) float32; pre (B,4,D) the
    input projections -> (new state, h (B,D) float32)."""
    c, n, m, h = state
    B, D = h.shape
    H = cfg.num_heads
    dh = D // H
    rec = torch.einsum("bhk,hkj->bhj", h.reshape(B, H, dh), r_all)          # (B,H,4dh)
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4, D)
    z = torch.tanh(pre[:, 0] + rec[:, 0] + p.b_z.float())
    it = pre[:, 1] + rec[:, 1] + p.b_i.float()
    ft = -F.softplus(-(pre[:, 2] + rec[:, 2] + p.b_f.float()))              # log sigmoid
    o = torch.sigmoid(pre[:, 3] + rec[:, 3] + p.b_o.float())
    m_new = torch.maximum(ft + m, it)
    fe = torch.exp(ft + m - m_new)
    ie = torch.exp(it - m_new)
    c_new = fe * c + ie * z
    n_new = fe * n + ie
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_out(p, h):
    u = h @ p.w_up.to(h.dtype)
    return F.gelu(u.float(), approximate="tanh").to(h.dtype) @ p.w_down.to(h.dtype)


def slstm_forward(p, cfg, x, *, bptt_chunk: int | None = None):
    """x (B,S,D) -> (out (B,S,D), state {c, n, m, h})."""
    B, S, D = x.shape
    r_all = _slstm_recurrent(p, cfg)
    z0 = torch.zeros(B, D, dtype=torch.float32, device=x.device)

    def step(state, xs_t):
        state, h = slstm_step(p, cfg, r_all, state, xs_t[0])
        return state, h.to(x.dtype)

    (c, n, m, h), hs = time_scan(step, (z0, z0, z0, z0), (_slstm_inputs(p, x),),
                                 bptt_chunk=bptt_chunk)
    return _slstm_out(p, hs), {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(p, cfg, x, state, rows=None):
    """x (B,1,D), state {c, n, m, h} updated in place (with ``rows``, a
    slot arena's pool rows) -> (out (B,1,D), state)."""
    names = ("c", "n", "m", "h")
    cur = L.state_rows(state, rows)
    new, h = slstm_step(p, cfg, _slstm_recurrent(p, cfg), tuple(cur[k] for k in names),
                        _slstm_inputs(p, x[:, 0]))
    out = _slstm_out(p, h.to(x.dtype))
    L.put_state(state, dict(zip(names, new)), rows)
    return out[:, None, :], state


def slstm_state_axes() -> dict:
    return {k: ("batch", "state") for k in ("c", "n", "m", "h")}


def slstm_state_spec(cfg, batch: int, *, device=None):
    device = resolve_device(device)
    return {k: torch.zeros(batch, cfg.d_model, dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}
