"""Common layers as functions on tensors. Counterpart of
``repro/models/layers.py``: each op casts its weights to the activation's
dtype, and the norms compute in float32 and return the input's dtype.
``rmsnorm`` and ``head_rmsnorm`` go through the RMSNorm kernel wrapper:
its kernel for CUDA tensors, its plain version for CPU tensors."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import rmsnorm as KR


def init_rmsnorm(mk, dim: int):
    return {"scale": mk((dim,), ("embed",), init="ones")}


def rmsnorm(scale, x, eps: float = 1e-6):
    return KR.rmsnorm(x, scale, eps)


def head_rmsnorm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm: x (..., head_dim), scale (head_dim,)."""
    return KR.rmsnorm(x, scale, eps)


def init_layernorm(mk, dim: int):
    return {"scale": mk((dim,), ("embed",), init="ones"),
            "bias": mk((dim,), ("embed",), init="zeros")}


def layernorm(scale, bias, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def state_rows(state: dict, rows) -> dict:
    """A recurrent decode state's rows: the pool's rows ``rows`` (B,) int64
    gathered (a slot arena's step), or with ``rows`` None the state
    itself."""
    if rows is None:
        return state
    return {name: t.index_select(0, rows) for name, t in state.items()}


def put_state(state: dict, new: dict, rows) -> None:
    """Write a decode step's new state into ``state`` in place: whole, or
    at the pool's rows ``rows`` (``state_rows``), so that a captured step
    keeps its addresses. Padding rows all name one spare row, whose value
    nothing live reads."""
    for name, t in new.items():
        if rows is None:
            state[name].copy_(t)
        else:
            state[name].index_copy_(0, rows, t.to(state[name].dtype))


def init_embedding(mk, vocab: int, dim: int):
    return {"table": mk((vocab, dim), ("vocab", "embed"), scale=1.0 / math.sqrt(dim))}


def embed(table, ids, dtype=None):
    out = table[ids]
    return out.to(dtype) if dtype is not None else out


def dense(w, x):
    return x @ w.to(x.dtype)


def init_gelu_mlp(mk, d_model: int, d_ff: int):
    return {"w_in": mk((d_model, d_ff), ("embed", "mlp"), scale=1.0 / math.sqrt(d_model)),
            "b_in": mk((d_ff,), ("mlp",), init="zeros"),
            "w_out": mk((d_ff, d_model), ("mlp", "embed"), scale=1.0 / math.sqrt(d_ff)),
            "b_out": mk((d_model,), ("embed",), init="zeros")}


def gelu_mlp(w_in, b_in, w_out, b_out, x):
    """``jax.nn.gelu`` defaults to the tanh approximation; so does this."""
    h = dense(w_in, x) + b_in.to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(w_out, h) + b_out.to(x.dtype)


def init_swiglu(mk, d_model: int, d_ff: int):
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"w_gate": mk((d_model, d_ff), ("embed", "mlp"), scale=s_in),
            "w_up": mk((d_model, d_ff), ("embed", "mlp"), scale=s_in),
            "w_down": mk((d_ff, d_model), ("mlp", "embed"), scale=s_out)}


def swiglu(p, x):
    """The SiLU runs in float32 and is cast back, as in the reference."""
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down.to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def rope_tables(positions, head_dim: int, theta: float = 10000.0):
    """positions (..., seq) -> (cos, sin), each (..., seq, 1, head_dim/2)
    float32; computed once per forward and shared by its layers."""
    freqs = _rope_freqs_on(head_dim, float(theta), positions.device)
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope_tables(x, cos, sin):
    """Split-halves RoPE of x (..., seq, heads, head_dim) from ``rope_tables``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Split-halves RoPE. x (..., seq, heads, head_dim); positions (..., seq)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoidal_embedding(positions, dim: int, max_period: float = 10000.0):
    """positions (...,) -> (..., dim) float32, ``[cos, sin]`` in that order."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = positions.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# -- parameters ----------------------------------------------------------------
#
# Every init function takes a maker ``mk(shape, axes, *, init, scale,
# dtype)``: ``axes`` names each dim logically ("embed", "heads", "batch",
# ...), as the reference's makers do. The same init code then gives real
# weights (``Maker``), meta tensors (``SpecMaker``) or the names alone
# (``AxesMaker``), the rule tables' input (``repro_torch.dist``), so that
# weights, specs and shardings cannot drift apart.


class Maker:
    """Draws weights as ``repro``'s ``ArrayMaker`` scales them: normal times
    ``scale`` (default 1/sqrt(fan-in), fan-in = product of all dims but the
    last), or zeros, or ones. Numbers come from ``generator``, on ``device``;
    ``dtype`` per call overrides the maker's."""

    def __init__(self, generator, dtype, device):
        self.generator, self.dtype, self.device = generator, dtype, torch.device(device)

    def __call__(self, shape, axes, *, init="normal", scale=None, dtype=None):
        assert len(shape) == len(axes), (shape, axes)
        kw = dict(dtype=dtype or self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if scale is None:
            scale = 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (w * scale).to(kw["dtype"])


class SpecMaker:
    """Shapes without memory: ``init_model``, ``init_unet`` or any init
    function called with it returns ``torch.empty`` tensors of ``dtype`` on
    the meta device, drawing nothing. Counterpart of ``repro``'s
    ``SpecMaker`` (its ``jax.ShapeDtypeStruct`` leaves): the step builders
    build full-size models, caches and optimizer states with it, and a step
    runs on them under the meta device's shape rules."""

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype

    def __call__(self, shape, axes, *, init="normal", scale=None, dtype=None):
        assert len(shape) == len(axes), (shape, axes)
        return torch.empty(tuple(shape), dtype=dtype or self.dtype, device="meta")


class AxesMaker:
    """The logical axis names alone: an init function called with it
    returns its tree with a tuple of names (``None`` for a dim no rule
    names) at every leaf."""

    def __call__(self, shape, axes, *, init="normal", scale=None, dtype=None):
        assert len(shape) == len(axes), (shape, axes)
        return tuple(axes)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def map_axes(fn, tree):
    """``fn`` applied to every axes leaf of a nested dict/list tree (``None``
    entries kept)."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [None if v is None else map_axes(fn, v) for v in tree]
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def tree_module(tree) -> nn.Module:
    """A module whose children mirror a nested dict/list of tensors: dicts
    become modules, lists ``ModuleList`` (``None`` entries kept), tensors
    parameters. They are created with ``requires_grad=False``, so sampling
    and decoding build no autograd graph; a trainer turns them on with
    ``module.requires_grad_(True)``. State-dict keys are the tree's paths
    joined by '.'."""
    if isinstance(tree, list):
        return nn.ModuleList([None if t is None else tree_module(t) for t in tree])
    return adopt_tree(nn.Module(), tree)


def adopt_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Registers a dict of tensors and subtrees on ``module``, as
    ``tree_module`` does."""
    for name, v in tree.items():
        if isinstance(v, torch.Tensor):
            module.register_parameter(name, nn.Parameter(v, requires_grad=False))
        else:
            module.add_module(name, tree_module(v))
    return module
