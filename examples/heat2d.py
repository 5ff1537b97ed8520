#!/usr/bin/env python
"""Implicit 2D heat-equation demo — analog of the reference heat2d.py
(heat2d.py:97-168): backward-Euler steps of

    (MM + kappa dt OP) p^{n+1} = MM p^n + kappa dt b

with the SIP-assembled operator OP, mass matrix MM, and inhomogeneous
boundary data folded into the load vector b via the buildBcRhs analog
(Poisson2DSparseMatrix.cpp:319-487). A hot Dirichlet wall at x=-1 drives
diffusion into the initially cold box; prints the temperature profile as it
relaxes toward the boundary-driven steady state.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.sparse.linalg as spla

from blitzdg_jax.mesh import box_triangles, read_gmsh
from blitzdg_jax.ops.poisson import assemble_bc_rhs, assemble_poisson2d
from blitzdg_jax.specgrid.triangle import build_triangle_context


def main():
    N = 2
    ref_mesh = "/root/reference/input/box.msh"
    mesh = read_gmsh(ref_mesh) if os.path.exists(ref_mesh) else box_triangles(10, 10)
    ctx = build_triangle_context(N, mesh, dtype=None)  # host f64 (implicit path)
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    print(f"K={K}, N={N}, ndof={K * ctx.n_p}")

    OP, MM = assemble_poisson2d(ctx)

    kappa, dt = 1.0, 1e-2
    # hot left wall: ubc = 1 on x=-1, 0 on the other (Dirichlet) walls
    xface = ctx.x.reshape(-1)[np.asarray(ctx.vmapM)].reshape(K, n_tr)
    ubc = np.where(np.abs(xface - xface.min()) < 1e-8, 1.0, 0.0)
    b = assemble_bc_rhs(ctx, ubc, np.zeros_like(ubc)).reshape(-1)

    # one factorization, reused every step (reference heat2d.py:141-150)
    lu = spla.splu((MM + kappa * dt * OP).tocsc())
    p = np.zeros(K * ctx.n_p)
    xflat = np.asarray(ctx.x).reshape(-1)
    near_hot = xflat < xflat.min() + 0.2

    for step in range(1, 201):
        p = lu.solve(MM @ p + kappa * dt * b)
        if step % 40 == 0:
            print(
                f"step={step} t={step * dt:.2f} "
                f"T_max={p.max():.4f} T_hot_region={p[near_hot].mean():.4f}"
            )

    if not np.all(np.isfinite(p)):
        raise RuntimeError("heat2d produced non-finite temperatures")
    # steady state of the driven problem is bounded by the wall data
    # (modulo a small Gibbs overshoot from the discontinuous corner BC)
    assert p.max() < 1.3 and p.min() > -0.3, (p.min(), p.max())
    print(f"done: T in [{p.min():.4f}, {p.max():.4f}], "
          f"hot-wall mean {p[near_hot].mean():.4f}")


if __name__ == "__main__":
    main()
