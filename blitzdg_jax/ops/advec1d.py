"""1D linear advection: upwind-flux DG right-hand side.

Functional parity target: reference advec1d::computeRHS
(/root/reference/src/advec1d/main.cpp:126-188):

    RHS = -c * rx * (Dr u) + Lift (Fscale * du),
    du  = (uM - uP) * 0.5 * (c n - (1-alpha)|c n|),  alpha=0 (upwind)

with inflow uP=0 at mapI and outflow uP=uM at mapO. Expressed element-major:
the gathers ride `take` on a flat view, the two small GEMMs are
batched over K, and XLA fuses the elementwise flux algebra between them.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import dg_op
from ..context import DGContext1D


@dg_op
def advec1d_rhs(ctx: DGContext1D, u: jnp.ndarray, t, c: float, alpha: float = 0.0) -> jnp.ndarray:
    """du/dt for u: (K, Np) (or any leading-batched (..., K, Np))."""
    uM, uP = ctx.surface_trace(u)

    # Boundary conditions: outflow copies the interior trace, inflow is 0.
    uP = uP.at[..., ctx.mapO].set(uM[..., ctx.mapO])
    uP = uP.at[..., ctx.mapI].set(0.0)

    nxf = ctx.nx.reshape(-1)
    cn = c * nxf
    du = (uM - uP) * 0.5 * (cn - (1.0 - alpha) * jnp.abs(cn))
    du = du.reshape(*u.shape[:-2], ctx.k_elem, ctx.n_faces * ctx.n_fp)

    vol = -c * ctx.rx * (u @ ctx.Dr.T)
    surf = (ctx.fscale * du) @ ctx.lift.T
    return vol + surf
