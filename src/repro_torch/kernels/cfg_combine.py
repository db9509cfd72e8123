"""Guidance-combine kernels: wrappers over ``csrc/cfg_combine.cu``, with the
plain PyTorch version of each beside it.

* ``cfg_combine``          Eq. 1, ``u + s * (c - u)`` (replaces
                           ``repro/kernels/cfg_combine.py::cfg_combine_pallas``);
* ``cfg_combine_rowscale`` Eq. 1 with one scale per batch row (replaces
                           ``cfg_combine_rowscale_pallas``);
* ``apg_combine``          APG normalised/projected guidance, arXiv 2410.02416
                           (replaces ``apg_combine_pallas``; with ``diff``
                           or a (B,) scale vector it computes what
                           ``apg_combine_ref`` does).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fallback. At the main
paths' shapes B1 and B3 are bound by launch latency; ``combine_plan`` is
their launch plan and the source note in ``cfg_combine.cu`` says why.
``LAUNCHES`` counts kernel launches by name.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

EPS = 1e-12   # guards zero-norm rows; rows with u == c stay exact
LAUNCHES = {"cfg_combine": 0, "cfg_combine_rowscale": 0, "apg_combine": 0}
VECS = 2               # accesses a thread (kVecs in csrc/cfg_combine.cu)


class CombinePlan(NamedTuple):
    """``width`` elements an access (one 16-byte vector, or 1: the scalar
    path), ``threads`` a block, ``vecs`` accesses a thread, ``blocks``."""
    width: int
    threads: int
    vecs: int
    blocks: int


@functools.lru_cache(maxsize=512)
def combine_plan(n: int, feat: int | None, dtype: torch.dtype,
                 aligned: bool = True) -> CombinePlan:
    """B1 (``feat`` None) or B3 (rows of ``feat``) over n elements: 16-byte
    accesses if the pointers are ``aligned`` and, for B3, a row is whole
    vectors; ``VECS`` accesses a thread; blocks of 64 threads while that
    takes no more blocks than ``build.NUM_SMS``, else of 128, so that a
    launch of up to half a million accesses is one wave over every SM it
    needs."""
    V = build.VEC[dtype]
    width = V if aligned and (feat is None or feat % V == 0) else 1
    acc = -(-n // width)
    threads = 64 if -(-acc // (64 * VECS)) <= build.NUM_SMS else 128
    return CombinePlan(width, threads, VECS, -(-acc // (threads * VECS)))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions (the CPU path, and what the kernels are held against) ----


def cfg_combine_plain(eps_uncond, eps_cond, scale: float):
    u, c = eps_uncond.float(), eps_cond.float()
    return (u + scale * (c - u)).to(eps_cond.dtype)


def cfg_combine_rowscale_plain(eps_uncond, eps_cond, scales):
    u, c = eps_uncond.float(), eps_cond.float()
    s = scales.float().reshape(-1, *([1] * (c.ndim - 1)))
    return (u + s * (c - u)).to(eps_cond.dtype)


def apg_combine_plain(eps_uncond, eps_cond, scale, *, eta: float = 0.0,
                      threshold: float = 0.0, diff=None):
    u, c = eps_uncond.float(), eps_cond.float()
    if isinstance(scale, torch.Tensor):
        scale = scale.float().reshape(-1, *([1] * (c.ndim - 1)))
    d = (c - u) if diff is None else diff.float()
    dims = tuple(range(1, c.ndim)) if c.ndim > 1 else (0,)
    if threshold > 0.0:
        d_norm = torch.sqrt((d * d).sum(dims, keepdim=True))
        d = d * torch.clamp(threshold / torch.clamp(d_norm, min=EPS), max=1.0)
    c_norm = torch.sqrt((c * c).sum(dims, keepdim=True))
    v1 = c / torch.clamp(c_norm, min=EPS)
    d_par = (d * v1).sum(dims, keepdim=True) * v1
    return (c + (scale - 1.0) * ((d - d_par) + eta * d_par)).to(eps_cond.dtype)


# -- wrappers ------------------------------------------------------------------


def _check_pair(u, c):
    if u.shape != c.shape or u.dtype != c.dtype:
        raise ValueError(f"eps_uncond {tuple(u.shape)} {u.dtype} vs eps_cond "
                         f"{tuple(c.shape)} {c.dtype}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _rows(c) -> tuple[int, int]:
    """(rows, features): the leading axis is the batch (one row for 1-D)."""
    if c.ndim <= 1:
        return 1, c.numel()
    return c.shape[0], c.numel() // max(c.shape[0], 1)


def cfg_combine(eps_uncond, eps_cond, scale: float):
    """Eq. 1. At ``scale == 1.0`` returns ``eps_cond`` itself, launching
    nothing: the COND skip is lossless only if this is bit-exact."""
    _check_pair(eps_uncond, eps_cond)
    scale = float(scale)
    if scale == 1.0:
        return eps_cond
    if not build.on_cuda(eps_uncond, eps_cond):
        return cfg_combine_plain(eps_uncond, eps_cond, scale)
    build.check_inputs(eps_uncond, eps_cond)
    out = torch.empty_like(eps_cond)
    n = eps_cond.numel()
    if n == 0:
        return out
    plan = combine_plan(n, None, eps_cond.dtype, _aligned(eps_uncond, eps_cond, out))
    lib = build.load()
    code = lib.cfg_combine(eps_uncond.data_ptr(), eps_cond.data_ptr(), out.data_ptr(), n,
                           scale, build.DTYPES[eps_cond.dtype], *plan, build.stream(eps_cond))
    build.check(lib, "cfg_combine", code)
    LAUNCHES["cfg_combine"] += 1
    return out


def cfg_combine_rowscale(eps_uncond, eps_cond, scales):
    """Eq. 1 with ``scales`` (B,), one per leading-axis row. No short-circuit:
    a row at scale 1.0 computes ``u + 1.0 * (c - u)``."""
    _check_pair(eps_uncond, eps_cond)
    rows, feat = _rows(eps_cond)
    if scales.shape != (rows,):
        raise ValueError(f"scales {tuple(scales.shape)} for {rows} rows")
    if not build.on_cuda(eps_uncond, eps_cond, scales):
        return cfg_combine_rowscale_plain(eps_uncond, eps_cond, scales)
    build.check_inputs(eps_uncond, eps_cond)
    if scales.dtype != torch.float32 or not scales.is_contiguous():
        raise TypeError("scales must be contiguous float32")
    out = torch.empty_like(eps_cond)
    if out.numel() == 0:
        return out
    plan = combine_plan(rows * feat, feat, eps_cond.dtype, _aligned(eps_uncond, eps_cond, out))
    lib = build.load()
    code = lib.cfg_combine_rowscale(eps_uncond.data_ptr(), eps_cond.data_ptr(),
                                    out.data_ptr(), scales.data_ptr(), rows, feat,
                                    build.DTYPES[eps_cond.dtype], *plan,
                                    build.stream(eps_cond))
    build.check(lib, "cfg_combine_rowscale", code)
    LAUNCHES["cfg_combine_rowscale"] += 1
    return out


def apg_combine(eps_uncond, eps_cond, scale, *, eta: float = 0.0,
                threshold: float = 0.0, diff=None):
    """APG per batch row: ``d = c - u`` (or ``diff``, float32) norm-clamped
    to ``threshold`` (0 disables), split against ``c / |c|``, and
    ``c + (s - 1) * (d_orth + eta * d_par)``. ``scale`` is one float, or a
    (B,) float32 tensor with each row's own scale."""
    _check_pair(eps_uncond, eps_cond)
    rows, feat = _rows(eps_cond)
    per_row = isinstance(scale, torch.Tensor)
    if per_row and scale.shape != (rows,):
        raise ValueError(f"scales {tuple(scale.shape)} for {rows} rows")
    tensors = [eps_uncond, eps_cond] + [t for t in (diff, scale if per_row else None)
                                        if t is not None]
    if diff is not None and diff.shape != eps_cond.shape:
        raise ValueError(f"diff {tuple(diff.shape)} vs eps {tuple(eps_cond.shape)}")
    if not build.on_cuda(*tensors):
        return apg_combine_plain(eps_uncond, eps_cond, scale, eta=eta,
                                 threshold=threshold, diff=diff)
    build.check_inputs(eps_uncond, eps_cond, *([] if diff is None else [diff]))
    if diff is not None and diff.dtype != torch.float32:
        raise TypeError("diff must be float32")
    if per_row and (scale.dtype != torch.float32 or not scale.is_contiguous()):
        raise TypeError("scales must be contiguous float32")
    out = torch.empty_like(eps_cond)
    lib = build.load()
    code = lib.apg_combine(eps_uncond.data_ptr(), eps_cond.data_ptr(),
                           None if diff is None else diff.data_ptr(),
                           scale.data_ptr() if per_row else None, out.data_ptr(),
                           rows, feat, 0.0 if per_row else float(scale) - 1.0, float(eta),
                           float(threshold), build.DTYPES[eps_cond.dtype],
                           build.stream(eps_cond))
    build.check(lib, "apg_combine", code)
    LAUNCHES["apg_combine"] += 1
    return out
