"""The exchange between the ranks of a mesh: one process a device, every rank
running the same program on the same inputs (SPMD).

* :class:`Split`: how one tensor dim is split over a ``DeviceMesh`` (a spec
  entry: no axis, an axis name or a tuple of names), with this rank's shard
  index and the process group of the ranks that hold the other shards.
* :func:`all_gather`: a tensor from every rank of a split's group, stacked
  in the group's rank order (the shards' order) on every rank.
* :func:`merge_partials`: attention partials over disjoint key sets, each a
  rank's (o, lse), merged into the attention over their union.
* :func:`send`, :func:`recv`: one tensor from one shard's rank to another's.

The transport follows the group's backend: an ``nccl`` group gathers CUDA
tensors where they are; a ``gloo`` group gathers host tensors, so a CUDA
tensor is copied to the host and the result copied back (two processes
sharing one card cannot form an NCCL group).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Split:
    """A tensor dim split ``n`` ways over the mesh axes ``axes``; this rank
    holds shard ``index``; ``group`` joins the ranks holding the other
    shards (None when ``n`` is 1)."""

    axes: tuple = ()
    n: int = 1
    index: int = 0
    group: object = None


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_of(mesh, entry) -> Split:
    """The :class:`Split` of a spec entry on a ``DeviceMesh``: the shard
    index runs over the entry's axes first-outermost, as a ``DTensor``
    with ``Shard(d)`` on each of them lays the shards out."""
    axes = _axes(entry)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n, index = 1, 0
    for ax in axes:
        n *= sizes[ax]
        index = index * sizes[ax] + mesh.get_local_rank(ax)
    if n == 1:
        return Split(axes)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    return Split(axes, n, index, sub.get_group())


def all_gather(t: torch.Tensor, split: Split) -> torch.Tensor:
    """``t`` from every rank of ``split``'s group -> (n, *t.shape) on
    ``t``'s device, in rank order; ``t[None]`` where nothing splits."""
    if split.n == 1:
        return t[None]
    if dist.get_backend(split.group) == "nccl":
        out = torch.empty((split.n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=split.group)
        return out
    host = t.detach().to("cpu", copy=t.device.type != "cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(split.n)]
    dist.all_gather(parts, host, group=split.group)
    return torch.stack(parts).to(t.device)


def _global(split: Split, index: int) -> int:
    return dist.get_global_rank(split.group, index)


def send(t: torch.Tensor, split: Split, index: int) -> None:
    """Send ``t`` to the rank holding shard ``index`` of ``split``."""
    if dist.get_backend(split.group) != "nccl":
        t = t.to("cpu", copy=t.device.type != "cpu")
    dist.send(t.contiguous(), _global(split, index), group=split.group)


def recv(nbytes: int, split: Split, index: int, device) -> torch.Tensor:
    """``nbytes`` bytes (uint8) from the rank holding shard ``index`` of
    ``split``, on ``device``."""
    nccl = dist.get_backend(split.group) == "nccl"
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device if nccl else "cpu")
    dist.recv(buf, _global(split, index), group=split.group)
    return buf.to(device)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Partials o (n, ..., hd) float32 and lse (n, ...) float32, each over a
    disjoint key set, -> (o, lse) over their union: lse = logsumexp(lse_i)
    and o = sum_i exp(lse_i - lse) o_i in float32, summed in rank order. A
    partial at lse -inf (no key) adds nothing, whatever its o; where every
    lse is -inf, o = 0 and lse = -inf. One partial comes back as it is."""
    m = lse.amax(dim=0)
    some = m > -math.inf
    m = torch.where(some, m, 0.0)
    total = torch.exp(lse[0] - m)
    for i in range(1, lse.shape[0]):
        total = total + torch.exp(lse[i] - m)
    out_lse = torch.where(some, m + torch.log(total), -math.inf)
    out = None
    for i in range(o.shape[0]):
        c = torch.where(some, torch.exp(lse[i] - out_lse), 0.0)[..., None]
        term = torch.where(c > 0, c * o[i], 0.0)
        out = term if out is None else out + term
    return out, out_lse
