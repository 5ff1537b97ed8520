#!/usr/bin/env python
"""1D Poisson demo driver — analog of the reference poisson1d executable
(src/poisson1d/main.cpp:42-43): N=4, K=15 on [-1, 1], matrix-free SIP
Laplacian (Poisson1d.hpp:24-137) solved with restarted GMRES
(GMRESSolver.hpp defaults kspace=30, relTol=1e-6), manufactured solution
u = sin(pi x); prints the GMRES convergence record and max-norm error.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax.ops.poisson import apply_mass, poisson1d_op
from blitzdg_jax.solvers.krylov import gmres
from blitzdg_jax.specgrid.nodes1d import build_nodes1d


def main():
    N, K = 4, 15
    ctx = build_nodes1d(N, K, -1.0, 1.0)
    print(f"K={K}, N={N}, ndof={ctx.k_elem * ctx.n_p}")

    f = (np.pi**2) * jnp.sin(np.pi * ctx.x)
    b = apply_mass(ctx, f).reshape(-1)

    # the reference's relTol=1e-6 assumes f64; clamp to what the working
    # dtype can reach (float32 has a relative-residual floor ~1e-5)
    tol = max(1e-6, 100.0 * float(jnp.finfo(jnp.result_type(b)).eps))

    @jax.jit
    def solve(b):
        mv = lambda v: -poisson1d_op(ctx, v.reshape(ctx.k_elem, ctx.n_p)).reshape(-1)
        return gmres(mv, b, tol=tol, restart=30, maxiter=100)

    res = solve(b)
    u = np.asarray(res.x).reshape(ctx.k_elem, ctx.n_p)
    exact = np.sin(np.pi * np.asarray(ctx.x))
    err = np.max(np.abs(u - exact))
    print(
        f"GMRES: flag={int(res.flag)} cycles={int(res.iters)} "
        f"relres={float(res.relres):.3e}"
    )
    print(f"max-norm error vs exact: {err:.6e}")
    if not np.isfinite(err) or err > 1e-3:
        raise RuntimeError(f"poisson1d error too large: {err}")


if __name__ == "__main__":
    main()
