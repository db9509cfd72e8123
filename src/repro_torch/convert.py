"""Converts the reference's parameter trees into the port's state.

``from_jax_params(tree)`` takes ``{"unet": ..., "text": ...}`` as the
reference's ``SDPipeline.params`` holds it, with every leaf already a numpy
array, and returns ``{"unet": state_dict, "text": state_dict}`` for
``repro_torch.core.pipeline.SDPipeline.from_state``.
``from_jax_model_params(tree)`` takes a decoder's ``init_model`` tree the
same way and returns the state dict of
``repro_torch.models.transformer.Transformer``. ``to_jax_params(unet,
text)`` is the inverse of ``from_jax_params``: the two modules' parameters
as numpy arrays in the reference's tree and layout, for its
``SDPipeline.params`` or a checkpoint it can read. Dtypes are kept.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes) included through a uint16 view,
    since ``torch.from_numpy`` rejects it. Always a copy; a 0-d array stays
    0-d (``ascontiguousarray`` alone makes it 1-d)."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix=""):
    """Yield (dotted path, leaf); ``None`` entries (levels without attention)
    have no leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def unet_items(tree):
    """(port key, numpy leaf in the port's layout): conv weights HWIO -> OIHW."""
    for key, a in _flatten(tree):
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        yield key, a


def text_items(tree):
    """(port key, numpy leaf): the encoder's one scan segment of stacked
    ``attn`` blocks (leading ``layers`` axis) becomes ``layers.<i>``."""
    segs = tree["segments"]
    if len(segs) != 1 or not isinstance(segs[0], list) or len(segs[0]) != 1:
        raise ValueError("expected one scanned segment of one attn block")
    for key, a in _flatten(tree):
        if not key.startswith("segments."):
            yield key, a
    for key, a in _flatten(segs[0][0]):
        for i in range(a.shape[0]):
            yield f"layers.{i}.{key}", a[i]


def from_jax_params(tree) -> dict:
    return {"unet": {k: to_tensor(a) for k, a in unet_items(tree["unet"])},
            "text": {k: to_tensor(a) for k, a in text_items(tree["text"])}}


def model_items(tree):
    """(port key, numpy leaf) of a decoder tree: each scanned segment (a list
    of the pattern's blocks, every leaf with a leading ``layers`` axis) is
    unstacked into ``layers.<i>``, group by group; a plain segment (one
    block) is one layer."""
    for key, a in _flatten({k: v for k, v in tree.items() if k != "segments"}):
        yield key, a
    layer = 0
    for seg in tree["segments"]:
        if isinstance(seg, dict):
            for key, a in _flatten(seg):
                yield f"layers.{layer}.{key}", a
            layer += 1
            continue
        n = next(_flatten(seg[0]))[1].shape[0]
        for j, block in enumerate(seg):
            for key, a in _flatten(block):
                for i in range(n):
                    yield f"layers.{layer + i * len(seg) + j}.{key}", a[i]
        layer += n * len(seg)


def from_jax_model_params(tree) -> dict:
    return {k: to_tensor(a) for k, a in model_items(tree)}


def module_tree(module: nn.Module):
    """The nested dict/list of numpy arrays that ``layers.tree_module`` built
    ``module`` from (``None`` entries kept)."""
    if isinstance(module, nn.ModuleList):
        return [None if m is None else module_tree(m) for m in module]
    out = {name: p.detach().cpu().numpy() for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = module_tree(child)
    return out


def _to_hwio(tree):
    if isinstance(tree, dict):
        return {k: _to_hwio(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [None if v is None else _to_hwio(v) for v in tree]
    return np.transpose(tree, (2, 3, 1, 0)) if tree.ndim == 4 else tree


def to_jax_params(unet: nn.Module, text: nn.Module) -> dict:
    """-> ``{"unet": tree, "text": tree}`` of numpy arrays as the reference
    holds them: conv weights HWIO, the encoder's layers stacked into one
    scanned segment of one ``attn`` block."""
    t = module_tree(text)
    layers = t.pop("layers")
    stack = lambda *leaves: np.stack(leaves)  # noqa: E731
    t["segments"] = [[_tree_map(stack, *layers)]]
    return {"unet": _to_hwio(module_tree(unet)), "text": t}


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)
