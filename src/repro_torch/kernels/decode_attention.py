"""Flash-decode attention kernel: the wrapper over
``csrc/decode_attention.cu``, with its plain PyTorch version beside it
(replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``).

One query token per row, q (B,H,hd), against a linear cache k, v (B,S,K,hd):
key ``kpos`` is valid iff ``kpos <= pos`` and, with a window,
``kpos > pos - window``. Float32 softmax, out in q's dtype. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel (a split-K pass
and a combine pass, counted as one launch) or raises. Any capacity S: the
TPU kernel's ``S % 512`` does not apply. ``LAUNCHES`` counts kernel calls.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import grouped_attention_plain

LAUNCHES = {"decode_attention": 0}
MAX_HEAD_DIM = 256
CHUNK = 64         # keys per split; kChunk in csrc/decode_attention.cu


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


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


def decode_attention(q, k, v, pos: int, *, window: int | None = None):
    """q (B,H,hd); k, v (B,S,K,hd); ``pos`` a Python int in [0, S) ->
    (B,H,hd). The kernel takes contiguous float32 or bfloat16 and hd a
    multiple of 8 up to ``MAX_HEAD_DIM``."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[2] or q.shape[1] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "need q (B,H,hd) and k, v (B,S,K,hd) with H % K == 0")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    if not build.on_cuda(q, k, v):
        return decode_attention_plain(q, k, v, pos, window=window)
    build.check_inputs(q, k, v)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"pos {pos} outside the cache's {S} slots")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes hd a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    lo = max(0, pos - window + 1) if window is not None else 0
    first = lo // CHUNK
    nchunks = pos // CHUNK - first + 1
    out = torch.empty_like(q)
    scratch = torch.empty(B * H * nchunks * (hd + 2), dtype=torch.float32, device=q.device)
    lib = build.load()
    code = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), B, S, H, K, hd, pos, lo, first, nchunks,
                                1.0 / math.sqrt(hd), build.DTYPES[q.dtype], build.stream(q))
    build.check(lib, "decode_attention", code)
    LAUNCHES["decode_attention"] += 1
    return out
