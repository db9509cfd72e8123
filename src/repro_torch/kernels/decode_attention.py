"""Flash-decode attention kernel: the wrapper over
``csrc/decode_attention.cu``, with its plain PyTorch version beside it
(replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``).

One query token per row, q (B,H,hd), against a cache k, v (B,S,K,hd). A
linear cache: key ``kpos`` (slot ``kpos``) is valid iff ``kpos <= pos`` and,
with a window, ``kpos > pos - window``. A ring cache (``slot_pos``, the
sliding-window decode cache): slot ``s`` holds position ``slot_pos[s]``
(-1: empty) and is valid under the same rule. Float32 softmax, out in q's
dtype. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel (one cluster launch) or raises. Any capacity S: the TPU kernel's
``S % 512`` does not apply. ``decode_split_plan`` is the kernel's launch
plan. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import grouped_attention_plain

LAUNCHES = {"decode_attention": 0}
MAX_HEAD_DIM = 256
MAX_GROUP = 32     # query heads per kv head; kMaxGroup in csrc/decode_attention.cu
MAX_CLUSTER = 8    # blocks per (batch, kv head) cluster, the portable most; kMaxCluster
TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per tile: 128 bytes of each row


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


class DecodePlan(NamedTuple):
    """The keys' split: tiles of ``tile`` keys from ``first_key``, ``tiles``
    of them, ``per_block`` consecutive tiles for each of the ``cluster``
    blocks of one (batch, kv head). Valid positions start at ``lo``."""
    lo: int
    first_key: int
    tiles: int
    per_block: int
    cluster: int


def decode_split_plan(S: int, pos: int, window: int | None = None, ring: bool = False,
                      tile: int = 64) -> DecodePlan:
    """A linear cache's tiles cover [lo, pos] (the first one from lo rounded
    down to a tile), a ring's all S slots; they go to at most
    ``MAX_CLUSTER`` blocks, as many as their even split needs."""
    lo = max(0, pos - window + 1) if window is not None else 0
    first, end = (0, S) if ring else (lo - lo % tile, pos + 1)
    tiles = -(-(end - first) // tile)
    per = -(-tiles // MAX_CLUSTER)
    return DecodePlan(lo, first, tiles, per, -(-tiles // per))


def ring_valid(slot_pos, pos: int, window: int | None):
    """A ring's (S,) bool mask of the slots ``pos`` attends to."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid = valid & (slot_pos > pos - window)
    return valid


def decode_attention_plain(q, k, v, pos: int, *, window: int | None = None, valid=None):
    """Mirrors ``repro/kernels/ref.py::ref_decode_attention``. ``valid``, an
    (S,) bool mask, replaces the mask of ``pos`` and ``window`` (a ring
    cache's slots are not in position order)."""
    if valid is None:
        kpos = torch.arange(k.shape[1], device=q.device)
        valid = kpos <= pos
        if window is not None:
            valid = valid & (kpos > pos - window)
    return grouped_attention_plain(q[:, None], k, v, valid)[:, 0]


def decode_attention(q, k, v, pos: int, *, window: int | None = None, slot_pos=None):
    """q (B,H,hd); k, v (B,S,K,hd); ``pos`` a Python int, in [0, S) for a
    linear cache; ``slot_pos`` None (a linear cache) or a ring's (S,) int32
    slot positions -> (B,H,hd). The kernel takes contiguous float32 or
    bfloat16, hd a multiple of 8 up to ``MAX_HEAD_DIM`` and H/K up to
    ``MAX_GROUP``."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[2] or q.shape[1] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "need q (B,H,hd) and k, v (B,S,K,hd) with H % K == 0")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    if slot_pos is not None and (tuple(slot_pos.shape) != (k.shape[1],)
                                 or slot_pos.dtype != torch.int32):
        raise ValueError(f"slot_pos {tuple(slot_pos.shape)} {slot_pos.dtype}: need "
                         f"({k.shape[1]},) int32")
    ring = () if slot_pos is None else (slot_pos,)
    if not build.on_cuda(q, k, v, *ring):
        if slot_pos is None:
            return decode_attention_plain(q, k, v, pos, window=window)
        return decode_attention_plain(q, k, v, pos, valid=ring_valid(slot_pos, pos, window))
    build.check_inputs(q, k, v)
    build.check_aligned(k, v)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    pos = int(pos)
    if pos < 0 or (slot_pos is None and pos >= S):
        raise ValueError(f"pos {pos} outside the cache's {S} slots")
    if hd % 8 or hd > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM} and H/K up "
                         f"to {MAX_GROUP}, got hd {hd}, H/K {H // K}")
    if slot_pos is not None and not slot_pos.is_contiguous():
        raise ValueError("kernel takes a contiguous slot_pos")
    plan = decode_split_plan(S, pos, window, slot_pos is not None, TILE[q.dtype])
    out = torch.empty_like(q)
    lib = build.load()
    code = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                None if slot_pos is None else slot_pos.data_ptr(),
                                B, S, H, K, hd, pos, plan.lo, plan.first_key, plan.tiles,
                                plan.per_block, plan.cluster, 1.0 / math.sqrt(hd),
                                build.DTYPES[q.dtype], build.stream(q))
    build.check(lib, "decode_attention", code)
    LAUNCHES["decode_attention"] += 1
    return out
