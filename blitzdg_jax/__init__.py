"""blitzdg_jax — a JAX nodal discontinuous-Galerkin + MPC framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the blitzdg
reference library (nodal DG solvers in 1D/2D, elliptic solves, shallow-water
and related models), built for accelerators: element-major static-shaped
arrays, fused batched matmuls, `lax.scan` time stepping,
`jax.sharding.Mesh` scenario/element parallelism, and differentiable rollouts
for batched MPC / trajectory optimization.
"""
from . import context, timestepping
from .context import BC_DIRICHLET, BC_IN, BC_NEUMAN, BC_OUT, BC_WALL, DGContext1D, DGContext2D
from .specgrid.nodes1d import build_nodes1d

__version__ = "0.1.0"

__all__ = [
    "context",
    "timestepping",
    "DGContext1D",
    "DGContext2D",
    "build_nodes1d",
    "BC_IN",
    "BC_OUT",
    "BC_WALL",
    "BC_DIRICHLET",
    "BC_NEUMAN",
]
