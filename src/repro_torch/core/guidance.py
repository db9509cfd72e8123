"""Classifier-free guidance (Ho & Salimans), Eq. 1 of the paper, and the APG
and per-row combines. Counterpart of ``repro/core/guidance.py``.

The combines are those of ``repro_torch.kernels.cfg_combine``: CUDA tensors
go to its kernels, CPU tensors to their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cfg_combine import apg_combine, cfg_combine, cfg_combine_rowscale

__all__ = ["apg_combine", "cfg_combine", "cfg_combine_rowscale", "merge_cond_uncond",
           "split_cond_uncond"]


def split_cond_uncond(batched):
    """(2B, ...) -> ((B, ...) cond, (B, ...) uncond): cond is the first half."""
    b2 = batched.shape[0]
    if b2 % 2:
        raise ValueError(f"odd batch {b2}")
    return batched[: b2 // 2], batched[b2 // 2:]


def merge_cond_uncond(cond, uncond):
    return torch.cat([cond, uncond], dim=0)
