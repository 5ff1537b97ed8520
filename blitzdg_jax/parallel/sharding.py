"""Device meshes, sharded contexts, and shard_map placement specs.

Replacement for the reference's (unused) METIS partition maps and
the NCCL/MPI layer it never had (SURVEY.md §2.9). Two execution styles:

1. **pjit auto-sharding** — `shard_context` places every `(K, ...)` array
   with `PartitionSpec('element')`; the plain ops (`sw2d_rhs`, ...) run
   under jit and XLA inserts the collectives implied by the `vmapP` gather.
   Zero code changes to the physics; good baseline.

2. **ppermute halo exchange** (halo.py / blocked_shard.py, the deployable
   path) — precomputed per-shard send tables; each ring offset with
   traffic is ONE `lax.ppermute` of a fixed-size face buffer, so
   communication is proportional to the partition cut instead of the
   whole trace table. Full coastal physics, blocked-kernel speed.

(An earlier `sharded_sw2d_rhs` all_gather demonstrator — ship every trace
to every shard, gather '+' via the global mapP — was retired in round 5:
halo.halo_sw2d_rhs and parallel.blocked_shard subsume it in capability and
speed; see tests/test_parallel.py for the halo parity suite.)

The element axis must be pre-partitioned contiguously (partition.py) so a
plain `P('element')` sharding is also a good partition.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..context import DGContext2D


def make_device_mesh(
    n_scenario: int = 1, n_element: int = 1, devices=None
) -> Mesh:
    """Build a (scenario, element) device mesh."""
    if devices is None:
        devices = jax.devices()
    n = n_scenario * n_element
    arr = np.array(devices[:n]).reshape(n_scenario, n_element)
    return Mesh(arr, axis_names=("scenario", "element"))


# Context fields that carry a leading element (K) axis and therefore shard
# over the element mesh axis. Everything else — reference-element operators,
# GLOBAL index lists (bc_maps, mapB/vmapB, gather/scatter ids,
# face_nbr/face_flip), static metadata — is replicated. An explicit
# allowlist, NOT a shape heuristic: a padded BC index list can accidentally
# have length == K (e.g. box 4x4 at N=1: 32 wall trace nodes, 32 elements),
# and a shape-based rule would silently scatter it across shards, dropping
# most boundary conditions (each shard would apply only 1/n of them).
ELEMENT_SHARDED_FIELDS = frozenset({
    "x", "J", "rx", "nx", "fscale",                  # 1D + 2D shared
    "y", "ry", "sx", "sy", "ny", "sJ",               # 2D volume/face geometry
    "vmapM", "vmapP", "mapP", "bc_table",            # per-element index maps
})


# per-element (K-leading) arrays of the cubature / Gauss-face contexts —
# the reference-element operators (V, Dr, Ds, interp, quadrature nodes)
# stay replicated; the maps/BC tables stay replicated GLOBAL and are
# localized inside halo_sw2d_curved_rhs
CUBATURE_SHARDED_FIELDS = frozenset({
    "x", "y", "J", "rx", "ry", "sx", "sy", "W", "MM", "MMchol", "MMinv",
})
GAUSS_SHARDED_FIELDS = frozenset({"x", "y", "nx", "ny", "sJ", "W"})


def _specs_by_name(tree, names, axis):
    def spec(path, a):
        name = path[0].name if hasattr(path[0], "name") else str(path[0])
        if name in names and hasattr(a, "ndim") and a.ndim >= 1:
            return P(axis, *([None] * (a.ndim - 1)))
        return P()

    return jax.tree_util.tree_map_with_path(spec, tree)


def cubature_shard_specs(cub, axis: str = "element"):
    """shard_map in_specs for a CubatureContext2D (curved sharded path)."""
    return _specs_by_name(cub, CUBATURE_SHARDED_FIELDS, axis)


def gauss_shard_specs(gauss, axis: str = "element"):
    """shard_map in_specs for a GaussFaceContext2D: per-node geometry is
    element-sharded; interp and the GLOBAL maps/BC tables replicate."""
    return _specs_by_name(gauss, GAUSS_SHARDED_FIELDS, axis)


def context_shard_specs(ctx, axis: str = "element"):
    """PartitionSpec pytree for a DG context under shard_map: P(axis) on the
    leading dim of every ELEMENT_SHARDED_FIELDS array, P() elsewhere. Use
    as the context's in_spec for shard_map'd ops (halo_sw2d_rhs,
    halo_poisson2d_op)."""

    def spec(path, a):
        name = path[0].name if hasattr(path[0], "name") else str(path[0])
        if (name in ELEMENT_SHARDED_FIELDS and hasattr(a, "ndim")
                and a.ndim >= 1):
            return P(axis, *([None] * (a.ndim - 1)))
        return P()

    return jax.tree_util.tree_map_with_path(spec, ctx)


def shard_context(ctx: DGContext2D, mesh: Mesh, axis: str = "element") -> DGContext2D:
    """Place per-element arrays with P(axis); replicate reference-element
    operators. The element axis length must divide the mesh axis size."""
    el = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def place(name, a):
        if not hasattr(a, "shape") or a.ndim == 0:
            return a
        if name in ELEMENT_SHARDED_FIELDS and a.shape:
            return jax.device_put(a, NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1)))))
        return jax.device_put(a, rep)

    fields = {}
    for name in ctx.__dataclass_fields__:
        val = getattr(ctx, name)
        if name in ("bc_maps",):
            fields[name] = jax.tree.map(lambda a: jax.device_put(a, rep), val)
        elif isinstance(val, (int, float)):
            fields[name] = val
        else:
            fields[name] = place(name, val)
    return DGContext2D(**fields)
