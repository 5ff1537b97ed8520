#!/usr/bin/env python
"""2D Poisson demo driver — analog of the reference poisson2d executable
(src/poisson2d/main.cpp) and poisson2d.py splu driver.

Solves  Laplacian u = -2 pi^2 sin(pi x) sin(pi y)  with homogeneous
Dirichlet walls on the box mesh, matrix-free on device via GMRES, and
cross-checks against the host-assembled SIP operator + sparse direct solve.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax.mesh import box_triangles, read_gmsh
from blitzdg_jax.ops.poisson import assemble_poisson2d, poisson2d_op
from blitzdg_jax.solvers.krylov import gmres
from blitzdg_jax.specgrid.triangle import build_triangle_context


def main():
    N = 2
    ref_mesh = "/root/reference/input/box.msh"
    mesh = read_gmsh(ref_mesh) if os.path.exists(ref_mesh) else box_triangles(12, 12)
    ctx = build_triangle_context(N, mesh, dtype=jnp.float32)
    print(f"K={ctx.k_elem}, N={N}, ndof={ctx.k_elem * ctx.n_p}")

    uex = jnp.sin(np.pi * ctx.x) * jnp.sin(np.pi * ctx.y)
    f = -2.0 * np.pi**2 * uex

    @jax.jit
    def solve(b):
        mv = lambda v: poisson2d_op(ctx, v.reshape(ctx.k_elem, ctx.n_p)).reshape(-1)
        return gmres(mv, b, tol=1e-6, restart=200, maxiter=30)

    res = solve(f.reshape(-1))
    u = np.asarray(res.x)
    err = np.max(np.abs(u - np.asarray(uex).reshape(-1)))
    print(f"GMRES: flag={int(res.flag)} cycles={int(res.iters)} relres={float(res.relres):.3e}")
    print(f"max-norm error vs exact: {err:.6e}")

    # block-Jacobi preconditioned CG on the symmetrized operator (the
    # reference solves unpreconditioned — solvers/precon.py is new)
    from blitzdg_jax.ops.poisson import apply_mass
    from blitzdg_jax.solvers import block_jacobi_from_matvec, cg

    b_sym = -apply_mass(ctx, f).reshape(-1)
    mv_sym = lambda v: -poisson2d_op(
        ctx, v.reshape(ctx.k_elem, ctx.n_p), symmetrize=True).reshape(-1)
    precon = block_jacobi_from_matvec(
        lambda u: -poisson2d_op(ctx, u, symmetrize=True), ctx)
    res_p = cg(mv_sym, b_sym, tol=1e-6, maxiter=3000, precon=precon)
    res_u = cg(mv_sym, b_sym, tol=1e-6, maxiter=3000)
    print(f"CG   block-Jacobi: iters={int(res_p.iters)}  "
          f"unpreconditioned: iters={int(res_u.iters)}")

    # host oracle
    import scipy.sparse.linalg as spla

    ctx64 = build_triangle_context(N, mesh, dtype=None)  # host f64
    OP, MM = assemble_poisson2d(ctx64)
    uex64 = (np.sin(np.pi * ctx64.x) * np.sin(np.pi * ctx64.y)).reshape(-1)
    u_direct = spla.spsolve(OP.tocsc(), MM @ (2.0 * np.pi**2 * uex64))
    print(f"direct-solve oracle error: {np.max(np.abs(u_direct - uex64)):.6e}")
    print(f"matrix-free vs oracle:     {np.max(np.abs(u - u_direct)):.6e}")


if __name__ == "__main__":
    main()
