#!/usr/bin/env python
"""Shallow-water demo driver — analog of the reference sw2d-simple
executable (src/sw2d-simple/main.cpp:33-177): box mesh, N=1, Gaussian
free-surface bump over 10 m depth, wall BCs, SSP-RK2 + modal filter,
adaptive CFL timestep. Prints eta_max every chunk and final diagnostics.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax.mesh import box_triangles, read_gmsh
from blitzdg_jax.ops.sw2d import SWPhysics, SWState, apply_filter, sw2d_rhs, sw2d_timestep
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step


def main():
    N = 1
    cfl = 0.65
    ref_mesh = "/root/reference/input/box.msh"
    if os.path.exists(ref_mesh):
        mesh = read_gmsh(ref_mesh)
    else:
        mesh = box_triangles(16, 16)
    print(f"K={mesh.num_elements} triangles, N={N}")

    ctx = build_triangle_context(N, mesh, filter_cutoff=0.9 * N, filter_order=N,
                                 dtype=jnp.float32)
    phys = SWPhysics(g=9.81)

    eta0 = jnp.exp(-10.0 * ctx.x**2 - 10.0 * ctx.y**2)
    state = SWState(h=10.0 + eta0, hu=jnp.zeros_like(eta0), hv=jnp.zeros_like(eta0))

    rhs = lambda s, t: sw2d_rhs(ctx, s, t, phys)
    post = lambda f: apply_filter(ctx, f)

    @jax.jit
    def chunk(state, t):
        def body(carry, _):
            s, tt = carry
            dt = sw2d_timestep(ctx, s, phys.g, cfl)
            s = ssprk2_step(rhs, s, tt, dt, post_stage=post)
            return (s, tt + dt), None

        (s, t), _ = jax.lax.scan(body, (state, t), None, length=100)
        return s, t

    t = jnp.float32(0.0)
    for i in range(10):
        state, t = chunk(state, t)
        eta_max = float(jnp.max(jnp.abs(state.h - 10.0)))
        print(f"step={100 * (i + 1)} t={float(t):.4f} eta_max={eta_max:.6f}")
        if not np.isfinite(eta_max) or eta_max > 1e8:
            raise RuntimeError("numerical instability")
    print("done: stable" if np.isfinite(eta_max) else "unstable")


if __name__ == "__main__":
    main()
