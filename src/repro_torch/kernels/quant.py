"""Symmetric int8 KV quantization for the paged arena. Counterpart of
``repro/kernels/quant.py``, as torch ops (the reference writes it in plain
jnp, not Pallas).

One scale per (position, kv-head) row: the last (``head_dim``) axis shares
it, and scales are float32. For any row ``x`` with ``amax = max|x|``,

    |x - dequantize(quantize(x))| <= max(amax, EPS) / 254   elementwise,

half a quantization step. ``torch.round`` rounds half to even, as
``jnp.round`` does, so values and scales equal the reference's bit for bit.
"""

from __future__ import annotations

import torch

# amax floor: keeps the scale finite on all-zero and denormal rows
EPS = 1e-20
QMAX = 127.0


def quantize_kv(x, *, scale_dtype=torch.float32, eps: float = EPS):
    """x (..., hd) -> (values int8 (..., hd), scales (..., 1)), with
    ``scale = max(amax, eps) / 127`` and round-half-to-even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=eps) / QMAX
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale.to(scale_dtype)


def dequantize_kv(values, scales, dtype=torch.float32):
    """values int8 (..., hd) x scales (..., 1) -> (..., hd) in ``dtype``."""
    return (values.float() * scales.float()).to(dtype)


def roundtrip_bound(x):
    """Per-element bound on ``|x - dequantize(quantize(x))|``: half a
    quantization step, anchored at the row's amax."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp(amax, min=EPS).div(2.0 * QMAX).expand(x.shape)
