"""RMSNorm kernel: the wrapper over ``csrc/rmsnorm.cu``, with its plain
PyTorch version beside it (replaces
``repro/kernels/rmsnorm.py::rmsnorm_pallas``).

Per row of the last axis, ``x * rsqrt(mean(x^2) + eps) * scale`` in float32,
returned in x's dtype. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. At the decoders' shapes a launch is bound by
latency, not bytes; ``rmsnorm_plan`` is its launch plan and the source note
in ``rmsnorm.cu`` says why. ``LAUNCHES`` counts kernel launches, and
``LAUNCH_SHAPES`` the same launches by (rows, D).

Under autograd (grad enabled and x or scale requiring grad) a CUDA call
runs the same kernel inside ``RmsNormFn``, whose backward is the closed
form ``rmsnorm_backward`` in float32 torch ops: the reference has no
backward kernel (its training differentiates the jnp form).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"rmsnorm": 0}
LAUNCH_SHAPES: dict = {}     # (rows, D) -> launches
MAX_DIM = 8192
MAX_VECS = 4           # 16-byte vectors of x a thread holds (the register cap)
MAX_BLOCK = 256        # threads a block of sub-warp rows


class RmsPlan(NamedTuple):
    """``route`` "few_rows" (one block a row) or "many_rows" (a warp, several
    warps or a sub-warp a row, several rows a block); ``threads`` a row,
    ``vecs`` 16-byte vectors of x a thread, ``rows_per_block``, ``blocks``."""
    route: str
    threads: int
    vecs: int
    rows_per_block: int
    blocks: int


@functools.lru_cache(maxsize=512)
def rmsnorm_plan(rows: int, dim: int, dtype: torch.dtype) -> RmsPlan:
    """Fewer rows than ``build.NUM_SMS`` with dim > 256: one block a row,
    dim / 8 threads of 8 elements each. Otherwise many rows: with dim > 256, one
    block a row again but of 16 elements a thread (2 vectors of bf16, 4 of
    float32), in whole warps; with dim <= 256, a power-of-two sub-warp a row
    (8 elements a thread) and several rows a block, in whole warps."""
    if dim % 8 or not 8 <= dim <= MAX_DIM:
        raise ValueError(f"kernel takes a last axis that is a multiple of 8 up to "
                         f"{MAX_DIM}, got {dim}")
    base = 8 // build.VEC[dtype]           # vectors of 8 elements: 1 bf16, 2 float32
    per = dim // 8                         # threads at 8 elements a thread
    if per > 32:
        if rows < build.NUM_SMS:
            return RmsPlan("few_rows", -(-per // 32) * 32, base, 1, rows)
        threads = -(-per // 64) * 32       # 16 elements a thread
        return RmsPlan("many_rows", threads, 2 * base, 1, rows)
    threads = 1 << (per - 1).bit_length()
    group = 32 // threads                  # rows that make a whole warp
    rpb = min(MAX_BLOCK // threads, max(1, rows // build.NUM_SMS))
    rpb = max(group, rpb // group * group)
    return RmsPlan("many_rows", threads, base, rpb, -(-rows // rpb))


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0
    LAUNCH_SHAPES.clear()


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """Mirrors ``repro/kernels/ref.py::ref_rmsnorm``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_backward(x, scale, rstd, dy):
    """The gradients of ``rmsnorm`` from the saved per-row ``rstd`` =
    rsqrt(mean(x^2) + eps) (float32, (..., 1)), in float32: dscale =
    sum over rows of dy * xhat, dx = rstd * (g - xhat * mean(g * xhat))
    with xhat = x * rstd and g = dy * scale. -> (dx in x's dtype, dscale in
    scale's dtype)."""
    xhat = x.float() * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RmsNormFn(torch.autograd.Function):
    """The kernel's forward with ``rmsnorm_backward``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out = _launch(x, scale, eps)
        rstd = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, rstd, dy)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x (..., D), scale (D,) -> (..., D) in x's dtype. The kernel takes
    contiguous float32 or bfloat16 x and scale, 16-byte aligned, with D a
    multiple of 8 up to ``MAX_DIM``; under autograd it carries the gradient
    through ``RmsNormFn``."""
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale {tuple(scale.shape)} for rows of {D}")
    if not build.on_cuda(x, scale):
        return rmsnorm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return _launch(x, scale, eps)


def _launch(x, scale, eps: float):
    D = x.shape[-1]
    build.check_inputs(x, scale)
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("kernel takes 16-byte aligned x and scale")
    rows = x.numel() // D
    plan = rmsnorm_plan(rows, D, x.dtype)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = build.load()
    code = lib.rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
                       build.DTYPES[x.dtype], build.DTYPES[scale.dtype], plan.threads,
                       plan.vecs, plan.rows_per_block, build.stream(x))
    build.check(lib, "rmsnorm", code)
    LAUNCHES["rmsnorm"] += 1
    LAUNCH_SHAPES[rows, D] = LAUNCH_SHAPES.get((rows, D), 0) + 1
    return out
