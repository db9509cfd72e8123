"""RMSNorm kernel: the wrapper over ``csrc/rmsnorm.cu``, with its plain
PyTorch version beside it (replaces
``repro/kernels/rmsnorm.py::rmsnorm_pallas``).

Per row of the last axis, ``x * rsqrt(mean(x^2) + eps) * scale`` in float32,
returned in x's dtype. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. The kernel is memory-bound; the source note
in ``rmsnorm.cu`` says what its design does about that. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = {"rmsnorm": 0}
MAX_DIM = 8192


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """Mirrors ``repro/kernels/ref.py::ref_rmsnorm``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x (..., D), scale (D,) -> (..., D) in x's dtype. The kernel takes
    contiguous float32 or bfloat16 x and scale, 16-byte aligned, with D a
    multiple of 8 up to ``MAX_DIM``."""
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale {tuple(scale.shape)} for rows of {D}")
    if not build.on_cuda(x, scale):
        return rmsnorm_plain(x, scale, eps)
    build.check_inputs(x, scale)
    if D % 8 or not 8 <= D <= MAX_DIM:
        raise ValueError(f"kernel takes a last axis that is a multiple of 8 up to "
                         f"{MAX_DIM}, got {D}")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("kernel takes 16-byte aligned x and scale")
    out = torch.empty_like(x)
    lib = build.load()
    code = lib.rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // D, D,
                       float(eps), build.DTYPES[x.dtype], build.DTYPES[scale.dtype],
                       build.stream(x))
    build.check(lib, "rmsnorm", code)
    LAUNCHES["rmsnorm"] += 1
    return out
