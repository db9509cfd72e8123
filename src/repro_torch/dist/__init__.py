"""Distribution layer: the logical-axis rule tables, the spec allocator and
their meeting with DTensor placements. Counterpart of ``repro.dist``; its
jax-version shim (``repro.dist.compat``) has no counterpart."""

from repro_torch.dist.sharding import (P, RULES_LONG, RULES_SERVE, RULES_TRAIN, AxisRule,
                                       AxisRules, MeshShape, as_mesh_shape, constrain, local_shape,
                                       logical_to_spec, mesh_sizes, sanitize_spec,
                                       spec_placements, tree_shardings)

__all__ = [
    "AxisRule", "AxisRules", "MeshShape", "P", "RULES_LONG", "RULES_SERVE", "RULES_TRAIN",
    "as_mesh_shape", "constrain", "local_shape", "logical_to_spec", "mesh_sizes", "sanitize_spec",
    "spec_placements", "tree_shardings",
]
