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
``S % 512`` does not apply. The kernel reads ``pos`` from the device, as
the TPU kernel reads its scalar-prefetch ``pos``: ``decode_launch_plan``,
its launch, depends on shapes alone, and ``decode_split_plan`` mirrors the
split of the keys that each launch computes from ``pos``. A linear cache
also takes a position per row, and ``rows``, the cache row each query row
reads (the slot arena's step, rows read in place): the TPU kernel vmapped
over its ``pos``. With ``rows`` a ring cache is one ring a cache row,
``slot_pos`` (N, S) (a windowed model's slot arena). ``LAUNCHES`` counts
kernel launches, and ``LAUNCH_FORMS`` the same launches by form:
``"batch"`` (one position), ``"rows"`` (one a row) or ``"ring_rows"`` (a
ring a cache row).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import grouped_attention_plain

LAUNCHES = {"decode_attention": 0}
LAUNCH_FORMS: dict = {}   # "batch", "rows" or "ring_rows" -> launches
MAX_HEAD_DIM = 256
MAX_GROUP = 32     # query heads per kv head; kMaxGroup in csrc/decode_attention.cu
MAX_CLUSTER = 8    # blocks per (batch, kv head) cluster, the portable most; kMaxCluster
TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per tile: 128 bytes of each row


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0
    LAUNCH_FORMS.clear()


class DecodeLaunch(NamedTuple):
    """The launch: ``span`` tiles, the most that the keys one position
    attends to can span, over ``cluster`` blocks a (batch, kv head)."""
    span: int
    cluster: int


def decode_launch_plan(S: int, window: int | None = None, ring: bool = False,
                       tile: int = 64) -> DecodeLaunch:
    """B5's launch, from shapes alone, so that one launch (captured in a CUDA
    graph) serves every position: a linear cache without a window and a
    ring span all S slots' tiles, a window of W at most ceil(W / tile) + 1
    tiles; as many blocks as an even split of ``span`` tiles over at most
    ``MAX_CLUSTER`` needs."""
    tiles = -(-S // tile)
    span = tiles if ring or window is None else min(tiles, -(-window // tile) + 1)
    per = -(-span // MAX_CLUSTER)
    return DecodeLaunch(span, -(-span // per))


class DecodePlan(NamedTuple):
    """The keys' split at one position: tiles of ``tile`` keys from
    ``first_key``, ``tiles`` of them, ``per_block`` consecutive tiles for
    each of the first ``cluster`` blocks of one (batch, kv head); the
    launch's other blocks load nothing. Valid positions start at ``lo``."""
    lo: int
    first_key: int
    tiles: int
    per_block: int
    cluster: int


def decode_split_plan(S: int, pos: int, window: int | None = None, ring: bool = False,
                      tile: int = 64) -> DecodePlan:
    """What each block of ``decode_launch_plan``'s launch computes on the
    device from ``pos`` (``block_split`` in ``csrc/decode_attention.cu``):
    a linear cache's tiles cover [lo, pos] (the first one from lo rounded
    down to a tile), a ring's all S slots; the launch's blocks take
    ceil(tiles / cluster) each."""
    launch = decode_launch_plan(S, window, ring, tile)
    lo = max(0, pos - window + 1) if window is not None else 0
    first = 0 if ring else lo // tile
    tiles = launch.span if ring else min(pos // tile - first + 1, launch.span)
    per = -(-tiles // launch.cluster)
    return DecodePlan(lo, first * tile, tiles, per, -(-tiles // per))


def ring_valid(slot_pos, pos, window: int | None):
    """A ring's (S,) bool mask of the slots ``pos`` (an int or a
    one-element tensor) attends to; for rings a row, slot_pos (B, S) and
    pos (B, 1) give (B, S)."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid = valid & (slot_pos > pos - window)
    return valid


def linear_valid(S: int, pos, window: int | None, device):
    """A linear cache's mask of the keys ``pos`` attends to: (S,) for an int
    or a one-element tensor, (B, S) for a (B,) tensor of positions."""
    kpos = torch.arange(S, device=device)
    if torch.is_tensor(pos) and pos.numel() > 1:
        pos = pos.reshape(-1, 1)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (kpos > pos - window)
    return valid


def decode_attention_plain(q, k, v, pos, *, window: int | None = None, valid=None):
    """Mirrors ``repro/kernels/ref.py::ref_decode_attention`` (vmapped over
    rows for a (B,) ``pos``); ``pos`` an int, a one-element tensor or one
    position a row. ``valid``, an (S,) or a (B, S) bool mask, replaces the
    mask of ``pos`` and ``window`` (a ring cache's slots are not in position
    order)."""
    if valid is None:
        valid = linear_valid(k.shape[1], pos, window, q.device)
    if valid.ndim == 2:
        valid = valid[:, None, None, None, :]
    return grouped_attention_plain(q[:, None], k, v, valid)[:, 0]


def decode_attention(q, k, v, pos, *, window: int | None = None, slot_pos=None, rows=None):
    """q (B,H,hd); k, v (B,S,K,hd), or (N,S,K,hd) with ``rows``; ``pos`` a
    one-element int32 tensor on q's device (the kernel reads it there: one
    launch serves every position), a (B,) int32 tensor there (one position
    a row) or a Python int, in [0, S) for a linear cache (staged to the
    device); ``rows`` None or (B,) int32 on the device, the cache row each
    query row reads, each in [0, N); ``slot_pos`` None (a linear cache), a
    ring's (S,) int32 slot positions (one position, no ``rows``) or with
    ``rows`` (N, S), each cache row's ring -> (B,H,hd). The kernel takes contiguous float32 or bfloat16, hd a
    multiple of 8 up to ``MAX_HEAD_DIM`` and H/K up to ``MAX_GROUP``."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape \
            or (rows is None and k.shape[0] != q.shape[0]) \
            or k.shape[3] != q.shape[2] or q.shape[1] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "need q (B,H,hd) and k, v (B,S,K,hd) with H % K == 0")
    if rows is not None and (tuple(rows.shape) != (q.shape[0],) or rows.dtype != torch.int32):
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype}: need ({q.shape[0]},) int32")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    ring_shape = (k.shape[1],) if rows is None else (k.shape[0], k.shape[1])
    if slot_pos is not None and (tuple(slot_pos.shape) != ring_shape
                                 or slot_pos.dtype != torch.int32):
        raise ValueError(f"slot_pos {tuple(slot_pos.shape)} {slot_pos.dtype}: need "
                         f"{ring_shape} int32")
    on_device = torch.is_tensor(pos)
    per_row = on_device and pos.numel() > 1
    if on_device and (pos.numel() not in (1, q.shape[0]) or pos.dtype != torch.int32):
        raise ValueError(f"pos {tuple(pos.shape)} {pos.dtype}: need one or one a row, int32")
    if slot_pos is not None and per_row and rows is None:
        raise ValueError("a ring cache takes one position, or rows and one a row")
    extra = tuple(t for t in (slot_pos, pos if on_device else None, rows) if t is not None)
    if not build.on_cuda(q, k, v, *extra):
        if rows is not None:
            k, v = k[rows.long()], v[rows.long()]
        if slot_pos is None:
            return decode_attention_plain(q, k, v, pos, window=window)
        if rows is not None:
            slot_pos = slot_pos[rows.long()]
            pos = pos.reshape(-1, 1) if on_device else pos
        return decode_attention_plain(q, k, v, pos, valid=ring_valid(slot_pos, pos, window))
    build.check_inputs(q, k, v)
    build.check_aligned(k, v)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if hd % 8 or hd > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM} and H/K up "
                         f"to {MAX_GROUP}, got hd {hd}, H/K {H // K}")
    if any(not t.is_contiguous() for t in extra):
        raise ValueError("kernel takes a contiguous slot_pos, pos and rows")
    if not on_device:
        pos = int(pos)
        if pos < 0 or (slot_pos is None and pos >= S):
            raise ValueError(f"pos {pos} outside the cache's {S} slots")
        pos = torch.full((1,), pos, dtype=torch.int32, device=q.device)
    plan = decode_launch_plan(S, window, slot_pos is not None, TILE[q.dtype])
    out = torch.empty_like(q)
    lib = build.load()
    code = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                None if slot_pos is None else slot_pos.data_ptr(),
                                pos.data_ptr(), None if rows is None else rows.data_ptr(),
                                B, S, H, K, hd, window or 0, plan.span, plan.cluster,
                                int(per_row), 1.0 / math.sqrt(hd), build.DTYPES[q.dtype],
                                build.stream(q))
    build.check(lib, "decode_attention", code)
    LAUNCHES["decode_attention"] += 1
    form = "batch" if not (per_row or rows is not None) else \
        "rows" if slot_pos is None else "ring_rows"
    LAUNCH_FORMS[form] = LAUNCH_FORMS.get(form, 0) + 1
    return out
