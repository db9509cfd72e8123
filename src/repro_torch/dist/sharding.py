"""Logical-axis sharding: the rule tables and the spec allocator.
Counterpart of ``repro/dist/sharding.py``, framework-free.

Every parameter and cache of the port is labelled with *logical* axis
names at init time (``models.layers.AxesMaker`` trees mirror the parameter
and cache trees). This module is where those names meet a mesh:

* :class:`AxisRules`: one table per deployment regime (``RULES_SERVE``,
  ``RULES_TRAIN``, ``RULES_LONG``, the reference's, copied). A rule maps a
  logical name to the mesh axes it may absorb and a priority deciding who
  wins a contested mesh axis.
* :func:`logical_to_spec`: the allocator. Walks one tensor's names in
  priority order and assigns mesh axes under two invariants: each mesh
  axis at most once a tensor, and an axis group only where its size
  product divides the dim (else the dim falls to the next name of its
  fallback chain, or replicates).
* :func:`sanitize_spec`: clamps any spec to the same invariants.
* :class:`P`: the port's partition spec, a tuple of entries (``None``, an
  axis name or a tuple of names) equal by value.
* :class:`MeshShape`: a mesh's sizes and names without devices (the
  reference's ``AbstractMesh``): production meshes the dry-run prices.
* :func:`spec_placements`, :func:`local_shape`: a spec as DTensor
  placements on a ``torch.distributed.device_mesh.DeviceMesh``, and the
  shape each device holds.
* :func:`tree_shardings`: an axes tree and a tensor tree to specs, or to
  placements on a ``DeviceMesh``.
* :func:`constrain`: redistributes a ``DTensor`` to a spec's placements; a
  no-op on plain tensors (the reference's no-op outside a mesh).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Mapping


# Logical names without a rule entry (and ``None`` placeholders) replicate.
DEFAULT_PRIORITY = 9


@dataclass(frozen=True)
class AxisRule:
    """Mesh axes one logical dim may absorb, in preference order."""

    axes: tuple[str, ...] = ()
    priority: int = DEFAULT_PRIORITY


@dataclass(frozen=True)
class AxisRules:
    """A named, immutable logical-name -> :class:`AxisRule` table."""

    name: str
    table: Mapping[str, AxisRule]

    def rule(self, logical: str | None) -> AxisRule | None:
        if logical is None:
            return None
        return self.table.get(logical)

    def priority(self, logical: str | None) -> int:
        rule = self.rule(logical)
        return rule.priority if rule is not None else DEFAULT_PRIORITY

    def override(self, **axes_by_name) -> "AxisRules":
        """Rebind the mesh axes of some logical names (priorities kept).

        Backs the ``REPRO_RULE_OVERRIDE`` hillclimb knob in
        ``launch/steps.py``: ``rules.override(kv_seq=("model", "data"),
        state=())`` returns a new table, the originals are never mutated.
        """
        table = dict(self.table)
        for name, axes in axes_by_name.items():
            prev = table.get(name)
            pri = prev.priority if prev is not None else DEFAULT_PRIORITY
            table[name] = AxisRule(tuple(axes), pri)
        return AxisRules(f"{self.name}+override", table)


# ---------------------------------------------------------------------------
# Rule tables (DESIGN.md §3)
# ---------------------------------------------------------------------------
#
# Priorities: 0 beats 1 beats 2 for a contested mesh axis; ties break by
# tensor position. The fallback chains (kv_heads -> kv_seq, experts -> mlp)
# are encoded purely as priority order — the lower-priority name only gets
# the axis when the higher-priority owner failed divisibility.

RULES_SERVE = AxisRules("serve", {
    # data parallelism: batch over data, joined with pod on multi-pod meshes
    "batch":        AxisRule(("pod", "data"), 0),
    # vocab-parallel logits / embedding table
    "vocab":        AxisRule(("model",), 0),
    # tensor parallelism over heads; EP over the same axis for MoE
    "heads":        AxisRule(("model",), 1),
    "kv_heads":     AxisRule(("model",), 1),
    "experts":      AxisRule(("model",), 1),
    # fallback owners of the model axis (TP for MoE, flash-decode for GQA)
    "mlp":          AxisRule(("model",), 2),
    "kv_seq":       AxisRule(("model",), 2),
    # paged KV pool: the page-pool axis plays the arena role the slot/batch
    # axis plays for whole-row arenas; interior page offsets replicate
    "pages":        AxisRule(("pod", "data"), 1),
    "page":         AxisRule((), 3),
    # replicated at serve time
    "seq":          AxisRule((), 3),
    "embed":        AxisRule((), 3),
    "expert_embed": AxisRule((), 3),
    "head_dim":     AxisRule((), 3),
    "kv_lora":      AxisRule((), 3),
    "state":        AxisRule((), 3),
    "time":         AxisRule((), 3),
    "layers":       AxisRule((), 3),
})

RULES_TRAIN = AxisRules("train", {
    "batch":        AxisRule(("pod", "data"), 0),
    "vocab":        AxisRule(("model",), 0),
    "heads":        AxisRule(("model",), 1),
    "kv_heads":     AxisRule(("model",), 1),
    "experts":      AxisRule(("model",), 1),
    "mlp":          AxisRule(("model",), 1),
    # sequence parallelism for activations (loses model to any priority-0/1
    # owner present on the same tensor, e.g. vocab on the logits)
    "seq":          AxisRule(("model",), 1),
    "kv_seq":       AxisRule(("model",), 2),
    "pages":        AxisRule(("data",), 2),
    "page":         AxisRule((), 3),
    # FSDP: params' embed dim sharded over data (batch never appears on the
    # same tensor, so the axes don't contest)
    "embed":        AxisRule(("data",), 2),
    "expert_embed": AxisRule(("data",), 2),
    "head_dim":     AxisRule((), 3),
    "kv_lora":      AxisRule((), 3),
    "state":        AxisRule((), 3),
    "time":         AxisRule((), 3),
    "layers":       AxisRule((), 3),
})

RULES_LONG = AxisRules("long", {
    "batch":        AxisRule(("pod", "data"), 0),
    "vocab":        AxisRule(("model",), 0),
    "heads":        AxisRule(("model",), 1),
    "kv_heads":     AxisRule(("model",), 1),
    "experts":      AxisRule(("model",), 1),
    "mlp":          AxisRule(("model",), 2),
    # 500k-token caches: the sequence dim absorbs every axis the batch and
    # kv-head dims left on the table (batch=1 and MQA/GQA head counts are
    # the norm at long context); a paged pool's page axis does the same
    "kv_seq":       AxisRule(("pod", "data", "model"), 2),
    "pages":        AxisRule(("pod", "data", "model"), 2),
    "page":         AxisRule((), 3),
    "seq":          AxisRule((), 3),
    "embed":        AxisRule((), 3),
    "expert_embed": AxisRule((), 3),
    "head_dim":     AxisRule((), 3),
    "kv_lora":      AxisRule((), 3),
    "state":        AxisRule((), 3),
    "time":         AxisRule((), 3),
    "layers":       AxisRule((), 3),
})


# ---------------------------------------------------------------------------
# Specs and meshes
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry a tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim split over their product,
    first name outermost). Trailing ``None``s may be left out."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names, holding no devices: the counterpart
    of the reference's ``AbstractMesh``."""

    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.shape} and names {self.axis_names} differ "
                             "in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``MeshShape`` or a ``DeviceMesh`` (whose dims
    must be named)."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to meet the rule tables")
    return dict(zip(names, mesh.shape))


def as_mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` or a ``DeviceMesh`` as a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.shape), tuple(mesh_sizes(mesh)))


def _trimmed_spec(entries) -> P:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


# ---------------------------------------------------------------------------
# Allocator
# ---------------------------------------------------------------------------


def _absorb(candidates, dim, sizes, used):
    """Absorb mesh axes for one dim -> spec entry (or None).

    Considers only candidates present in the mesh and unused by this tensor
    so far, and picks the order-preserving subset with the **largest size
    product that divides** ``dim``. Maximising (rather than greedy prefix
    absorption) matters on multi-pod meshes: batch=16 on (pod=2, data=16)
    must take the 16-way ``data`` axis, not lock in ``pod`` and stop at
    2-way. Ties prefer earlier/fewer axes.
    """
    avail = [ax for ax in candidates if ax in sizes and ax not in used]
    best: tuple[str, ...] = ()
    best_prod = 0   # 0, not 1: a size-1 mesh axis is still worth naming
    for r in range(1, len(avail) + 1):
        for combo in itertools.combinations(avail, r):
            prod = math.prod(sizes[ax] for ax in combo)
            if prod > best_prod and dim % prod == 0:
                best, best_prod = combo, prod
    if not best:
        return None
    used.update(best)
    return best[0] if len(best) == 1 else best


def logical_to_spec(names, rules: AxisRules, *, shape, mesh) -> P:
    """Allocate mesh axes to one tensor's logical names -> ``P``.

    ``names``: one logical name a dim (``None`` replicates); ``shape``: the
    tensor's (divisibility checks); ``mesh``: a ``MeshShape`` or a
    ``DeviceMesh``. Dims are visited in rule-priority order (ties by
    position), each absorbing its candidate axes (``_absorb``), so
    indivisible dims fall through to the next name in the fallback chain or
    replicate.
    """
    names = tuple(names)
    shape = tuple(shape)
    if len(names) != len(shape):
        raise ValueError(f"names/shape rank mismatch: {names} vs {shape}")
    sizes = mesh_sizes(mesh)
    order = sorted(range(len(names)),
                   key=lambda i: (rules.priority(names[i]), i))
    used: set[str] = set()
    entries: list = [None] * len(names)
    for i in order:
        rule = rules.rule(names[i])
        if rule is None:
            continue
        entries[i] = _absorb(rule.axes, shape[i], sizes, used)
    return _trimmed_spec(entries)


def sanitize_spec(shape, spec, mesh) -> P:
    """Clamp an arbitrary spec to the allocator invariants.

    Drops axes that are absent from the mesh, already used earlier in the
    spec, or whose size product stops dividing the dim; trims trailing
    ``None``s. Idempotent on allocator output. A spec with more entries
    than the tensor has dims is a caller bug and raises.
    """
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec rank exceeds tensor rank: {spec} vs {shape}")
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        entries.append(_absorb(axes, dim, sizes, used))
    return _trimmed_spec(entries)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec``: each dim divided by its axes' size product (exact: the
    allocator assigns only dividing groups; anything else raises)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        n = math.prod(sizes[ax] for ax in _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {n} ways ({spec})")
        out[d] //= n
    return tuple(out)


def spec_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``),
    one a mesh dim: ``Shard(d)`` on every mesh dim that tensor dim d's entry
    names (on each of them where it names several), ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)):
        for ax in _entry_axes(entry):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Tree-level helpers
# ---------------------------------------------------------------------------


def _is_device_mesh(mesh) -> bool:
    return not isinstance(mesh, MeshShape)


def tree_shardings(axes_tree, tensor_tree, mesh, rules: AxisRules):
    """(axes tree, tensor tree) -> the tree of each tensor's ``P`` on a
    ``MeshShape``, or of its placements on a ``DeviceMesh``.

    The two trees mirror each other (dicts, lists with ``None`` entries
    kept); axes leaves are tuples of names (``layers.is_axes_leaf``) and
    tensor leaves anything with a ``.shape`` (meta tensors included).
    """
    from repro_torch.models.layers import is_axes_leaf

    def walk(axes, t):
        if is_axes_leaf(axes):
            spec = logical_to_spec(axes, rules, shape=t.shape, mesh=mesh)
            return spec_placements(spec, mesh) if _is_device_mesh(mesh) else spec
        if isinstance(axes, dict):
            if set(axes) != set(t):
                raise ValueError(f"axes and tensor trees differ: {sorted(axes)} vs {sorted(t)}")
            return {k: walk(axes[k], t[k]) for k in axes}
        if len(axes) != len(t):
            raise ValueError(f"axes and tensor lists differ in length: {len(axes)} vs {len(t)}")
        return [None if a is None else walk(a, x) for a, x in zip(axes, t)]

    return walk(axes_tree, tensor_tree)


def constrain(x, logical, rules: AxisRules | None):
    """Sharding hint: a ``DTensor`` redistributed to the placements that
    ``rules`` give its logical names on its own mesh; anything else (a
    plain tensor, or no rules) unchanged, as the reference's ``constrain``
    is a no-op outside a mesh."""
    from torch.distributed.tensor import DTensor
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical, rules, shape=x.shape, mesh=x.device_mesh)
    return x.redistribute(x.device_mesh, spec_placements(spec, x.device_mesh))
