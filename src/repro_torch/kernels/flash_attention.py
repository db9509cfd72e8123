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


def grouped_attention_plain(q, k, v, valid=None):
    """The one plain grouped-query attention body of the port. q (B,Q,H,hd),
    k, v (B,S,K,hd), ``valid`` a bool mask that broadcasts to (B,1,1,Q,S)
    or None -> (B,Q,H,hd). Scores from the einsum in q's dtype, softmax in
    float32, weights cast back to q's dtype (as ``repro/kernels/ref.py``)."""
    B, Q, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Q, K, H // K, hd)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float() / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkrqs,bskh->bqkrh", w, v).reshape(B, Q, H, hd)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int | None = None):
    """Mirrors ``repro/kernels/ref.py::ref_flash_attention``."""
    mask = None
    if causal or window is not None:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] <= pos[:, None] if causal else torch.ones(
            S, S, dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & (pos[None, :] > pos[:, None] - window)
    return grouped_attention_plain(q, k, v, mask)


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
    ``MAX_HEAD_DIM`` and H/K up to ``MAX_GROUP``."""
    _check_shapes(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    if not build.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
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
