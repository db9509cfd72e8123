"""Prefill flash-attention kernel: the wrapper over
``csrc/flash_attention.cu``, with its plain PyTorch version beside it
(replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``).

GQA attention of q (B,S,H,hd) over k, v (B,S,K,hd) at positions
``arange(S)``, causal and/or sliding-window masked, float32 softmax, out in
q's dtype. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises: bfloat16 the warpgroup tensor-core kernel, float32 the
CUDA-core one (the dtype is the one rule). Unlike the TPU kernel, S need not
divide by a tile: the kernels mask their tails. ``flash_tile_plan`` is the
bfloat16 kernel's launch plan. ``LAUNCHES`` counts kernel launches.

Under autograd (grad enabled and q, k or v requiring grad) a CUDA call
runs the same kernel inside ``FlashAttentionFn``, whose backward
``flash_attention_backward`` recomputes the probabilities in float32 torch
ops, one batch row at a time: the reference has no backward kernel (its
training differentiates the jnp form). A call whose backward would exceed
``MAX_BACKWARD_SCORES`` scores a batch row raises before it runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"flash_attention": 0}
NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_GROUP = 32     # query heads per kv head that one kernel block holds
ROWS = 64          # query rows per block: one consumer warpgroup's wgmma tile
PAD = 64           # hd is padded to a multiple of this in shared memory (128-byte rows)
MAX_BACKWARD_SCORES = 2 ** 30   # H x S x S float32 scores the backward holds a batch row


class FlashPlan(NamedTuple):
    """A bfloat16 launch: each block holds ``positions`` x rep query rows
    (``rows`` <= ``ROWS``) of one kv head's group, head dims padded to
    ``hd_pad`` in shared memory; ``q_tiles`` blocks per (batch, kv head)."""
    rows: int
    positions: int
    hd_pad: int
    q_tiles: int


def flash_tile_plan(S: int, H: int, K: int, hd: int) -> FlashPlan:
    rep = H // K
    if H % K or not 1 <= rep <= MAX_GROUP:
        raise ValueError(f"H {H}, K {K}: need H % K == 0 and H/K in [1, {MAX_GROUP}]")
    bq = ROWS // rep
    return FlashPlan(bq * rep, bq, -(-hd // PAD) * PAD, -(-S // bq))


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def grouped_attention_plain(q, k, v, valid=None, *, lse: bool = False):
    """The one plain grouped-query attention body of the port. q (B,Q,H,hd),
    k, v (B,S,K,hd), ``valid`` a bool mask that broadcasts to (B,1,1,Q,S)
    or None -> (B,Q,H,hd). Scores from the einsum in q's dtype, softmax in
    float32, weights cast back to q's dtype (as ``repro/kernels/ref.py``).
    With ``lse`` -> (out, the masked scores' log-sum-exp (B,Q,H) float32)."""
    B, Q, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Q, K, H // K, hd)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float() / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v).reshape(B, Q, H, hd)
    if not lse:
        return out
    return out, s.logsumexp(dim=-1).permute(0, 3, 1, 2).reshape(B, Q, H)


def _prefill_mask(S: int, causal: bool, window: int | None, device):
    """(S, S) bool, True where query row i attends key j, or None (all)."""
    if not causal and window is None:
        return None
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None] if causal else torch.ones(
        S, S, dtype=torch.bool, device=device)
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None):
    """Mirrors ``repro/kernels/ref.py::ref_flash_attention``."""
    return grouped_attention_plain(q, k, v, _prefill_mask(q.shape[1], causal, window, q.device))


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: int | None = None):
    """The gradients of ``flash_attention`` at (q, k, v) given its ``out``
    and the output gradient ``dout``, in float32, one batch row at a time:
    P = softmax(mask(q k^T / sqrt(hd))) recomputed, dV = P^T dO,
    dS = P * (dO V^T - rowsum(dO * O)), dQ = dS K / sqrt(hd),
    dK = dS^T Q / sqrt(hd); dK and dV summed over each kv head's group.
    -> (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rep, scale = H // K, 1.0 / math.sqrt(hd)
    mask = _prefill_mask(S, causal, window, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        qb = q[b].float().reshape(S, K, rep, hd)
        kb, vb = k[b].float(), v[b].float()
        dob = dout[b].float().reshape(S, K, rep, hd)
        s = torch.einsum("qkrh,skh->krqs", qb, kb) * scale
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv[b] = torch.einsum("krqs,qkrh->skh", p, dob)
        dp = torch.einsum("qkrh,skh->krqs", dob, vb)
        rows = (dob * out[b].float().reshape(S, K, rep, hd)).sum(-1)
        ds = p * (dp - rows.permute(1, 2, 0)[..., None])
        dq[b] = (torch.einsum("krqs,skh->qkrh", ds, kb) * scale).reshape(S, H, hd)
        dk[b] = torch.einsum("krqs,qkrh->skh", ds, qb) * scale
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward with ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _launch(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0] \
            or k.shape[1] != q.shape[1] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "need q (B,S,H,hd) and k, v (B,S,K,hd) with H % K == 0")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q (B,S,H,hd); k, v (B,S,K,hd) -> (B,S,H,hd). The kernel takes
    contiguous float32 or bfloat16, hd a multiple of 8 up to
    ``MAX_HEAD_DIM`` and H/K up to ``MAX_GROUP``; under autograd it carries
    the gradient through ``FlashAttentionFn``."""
    _check_shapes(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    if not build.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        S, H = q.shape[1], q.shape[2]
        if H * S * S > MAX_BACKWARD_SCORES:
            raise ValueError(f"the backward holds H x S x S = {H * S * S} float32 scores a "
                             f"batch row, over its {MAX_BACKWARD_SCORES}; run without grad")
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal: bool, window: int | None):
    build.check_inputs(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    if hd % 8 or hd > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM} and H/K up "
                         f"to {MAX_GROUP}, got hd {hd}, H/K {H // K}")
    build.check_aligned(q, k, v)
    plan = flash_tile_plan(S, H, K, hd)
    out = torch.empty_like(q)
    lib = build.load()
    code = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               B, S, H, K, hd, int(causal), window or 0, 1.0 / math.sqrt(hd),
                               build.DTYPES[q.dtype], plan.positions, build.stream(q))
    build.check(lib, "flash_attention", code)
    LAUNCHES["flash_attention"] += 1
    return out
