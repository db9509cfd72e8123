"""Guidance-combine kernels: wrappers over ``csrc/cfg_combine.cu``, with the
plain PyTorch version of each beside it.

* ``cfg_combine``          Eq. 1, ``u + s * (c - u)`` (replaces
                           ``repro/kernels/cfg_combine.py::cfg_combine_pallas``);
* ``cfg_combine_rowscale`` Eq. 1 with one scale per batch row (replaces
                           ``cfg_combine_rowscale_pallas``);
* ``apg_combine``          APG normalised/projected guidance, arXiv 2410.02416
                           (replaces ``apg_combine_pallas``; with ``diff`` it
                           computes what ``apg_combine_ref`` does).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fallback. All three
are memory-bound; the source note in ``cfg_combine.cu`` says how the
kernels deal with that. ``LAUNCHES`` counts kernel launches by name.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

EPS = 1e-12   # guards zero-norm rows; rows with u == c stay exact
LAUNCHES = {"cfg_combine": 0, "cfg_combine_rowscale": 0, "apg_combine": 0}


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


def apg_combine_plain(eps_uncond, eps_cond, scale: float, *, eta: float = 0.0,
                      threshold: float = 0.0, diff=None):
    u, c = eps_uncond.float(), eps_cond.float()
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
    lib = build.load()
    code = lib.cfg_combine(eps_uncond.data_ptr(), eps_cond.data_ptr(), out.data_ptr(),
                           eps_cond.numel(), scale, build.DTYPES[eps_cond.dtype],
                           build.stream(eps_cond))
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
    lib = build.load()
    code = lib.cfg_combine_rowscale(eps_uncond.data_ptr(), eps_cond.data_ptr(),
                                    out.data_ptr(), scales.data_ptr(), rows, feat,
                                    build.DTYPES[eps_cond.dtype], build.stream(eps_cond))
    build.check(lib, "cfg_combine_rowscale", code)
    LAUNCHES["cfg_combine_rowscale"] += 1
    return out


def apg_combine(eps_uncond, eps_cond, scale: float, *, eta: float = 0.0,
                threshold: float = 0.0, diff=None):
    """APG per batch row: ``d = c - u`` (or ``diff``, float32) norm-clamped
    to ``threshold`` (0 disables), split against ``c / |c|``, and
    ``c + (s - 1) * (d_orth + eta * d_par)``."""
    _check_pair(eps_uncond, eps_cond)
    tensors = (eps_uncond, eps_cond) if diff is None else (eps_uncond, eps_cond, diff)
    if diff is not None and diff.shape != eps_cond.shape:
        raise ValueError(f"diff {tuple(diff.shape)} vs eps {tuple(eps_cond.shape)}")
    if not build.on_cuda(*tensors):
        return apg_combine_plain(eps_uncond, eps_cond, scale, eta=eta,
                                 threshold=threshold, diff=diff)
    build.check_inputs(*tensors)
    if diff is not None and diff.dtype != torch.float32:
        raise TypeError("diff must be float32")
    rows, feat = _rows(eps_cond)
    out = torch.empty_like(eps_cond)
    lib = build.load()
    code = lib.apg_combine(eps_uncond.data_ptr(), eps_cond.data_ptr(),
                           None if diff is None else diff.data_ptr(), out.data_ptr(),
                           rows, feat, float(scale) - 1.0, float(eta), float(threshold),
                           build.DTYPES[eps_cond.dtype], build.stream(eps_cond))
    build.check(lib, "apg_combine", code)
    LAUNCHES["apg_combine"] += 1
    return out
