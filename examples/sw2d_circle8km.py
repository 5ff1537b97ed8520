#!/usr/bin/env python
"""Reference-scale curved coastal run: R_8km_circle.msh (K=858 — the mesh
the reference's own sw2d.py drives, /root/reference/sw2d.py:161), with the
curved pipeline of the reference's sw2d_curved.py: spline-fit boundary
(:81-100 equivalent), Gordon-Hall deformation, N=4, cubature order 3(N+1),
Gauss faces 2(N+1) (:47,117,148), tanh-ramp spatial drag (:170-185),
Coriolis, plus tidal BC_OUT forcing with ramp and a sponge layer near the
open arc (reference sw2d/main.cpp:347-353, 517-553)."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax.context import BC_OUT
from blitzdg_jax.mesh.curved import (
    boundary_loops,
    gordon_hall_deform,
    snap_boundary_vertices,
    spline_boundary_projection,
)
from blitzdg_jax.mesh.gmsh import read_gmsh
from blitzdg_jax.ops.sw2d import SWPhysics
from blitzdg_jax.ops.sw2d_curved import SWStateTracer, sw2d_curved_rhs
from blitzdg_jax.specgrid.cubature import (
    build_cubature_context,
    build_gauss_face_context,
)
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step
from blitzdg_jax.utils import build_sponge_coefficient


def main():
    N = 4
    mesh = read_gmsh(os.environ.get(
        "BLITZDG_MESH", "/root/reference/input/R_8km_circle.msh"))
    print(f"K={mesh.num_elements} vertices={len(mesh.verts)}")

    # tag an eastern arc of the coastline as the tidal open boundary
    bc = np.asarray(mesh.bc_type).copy()
    mids = 0.5 * (mesh.verts[mesh.etov]
                  + mesh.verts[np.roll(mesh.etov, -1, axis=1)])
    open_faces = (bc > 0) & (mids[:, :, 0] > 6500.0)
    bc[open_faces] = BC_OUT
    mesh.set_bc_type(bc)
    print(f"open-boundary faces: {int(open_faces.sum())}")

    # spline-fit boundary adapter: ordered coastline points -> parametric
    # spline -> closest-point projection, then Gordon-Hall blending
    loops = boundary_loops(mesh)
    pts = mesh.verts[loops[0][:-1]]
    proj = spline_boundary_projection(pts, periodic=True)
    curved_faces = snap_boundary_vertices(mesh, proj, tol=100.0)
    ctx0 = build_triangle_context(N, mesh, dtype=None)
    x2, y2, curved_els = gordon_hall_deform(N, mesh, ctx0.x, ctx0.y,
                                            curved_faces, proj)
    print(f"curved faces: {len(curved_faces)}, curved elements: "
          f"{len(curved_els)}")

    dtype = jnp.float32
    ctx = build_triangle_context(N, mesh, coords=(x2, y2),
                                 filter_cutoff=0.9 * N, filter_order=4,
                                 dtype=dtype)
    cub = build_cubature_context(N, mesh, x2, y2, ctx0.V,
                                 order=3 * (N + 1), dtype=dtype)
    gauss = build_gauss_face_context(N, mesh, x2, y2, ctx0.V,
                                     n_gauss=2 * (N + 1), dtype=dtype)
    area = float(jnp.sum(cub.W))
    print(f"area = {area:.6e} (circle: {np.pi * 8000.0**2:.6e})")

    # physics: depth 10 m, Coriolis, tanh drag ramp from the coast,
    # sponge near the open arc, M2-ish tidal forcing with spin-up ramp
    H0 = 10.0
    r = np.hypot(np.asarray(ctx0.x), np.asarray(ctx0.y))
    ltol = 800.0
    cd = 2.5e-3 * 0.5 * (1.0 - np.tanh(((8000.0 - r) - 0.5 * ltol)
                                       / (0.1 * ltol)))
    ob_mask = np.asarray(ctx.bc_table)[:, :, None].repeat(
        ctx.n_fp, 2).reshape(ctx.k_elem, -1) == BC_OUT
    sponge = build_sponge_coefficient(ctx, ob_mask, width=1500.0,
                                      strength=5e-3)
    phys = SWPhysics(g=9.81, cd=jnp.asarray(cd, dtype=dtype),
                     f_cor=7.88e-5, sponge=sponge)
    period, amp, ramp_tau = 3600.0, 0.25, 600.0
    tidal = lambda t: H0 + amp * jnp.cos(2 * np.pi * t / period) \
        * jnp.minimum(t / ramp_tau, 1.0)

    state = SWStateTracer(
        h=(H0 + jnp.zeros_like(ctx.x)).astype(dtype),
        hu=jnp.zeros_like(ctx.x).astype(dtype),
        hv=jnp.zeros_like(ctx.x).astype(dtype),
        hN=jnp.exp(-(((ctx.y - 2500.0) / 2000.0) ** 2)).astype(dtype))

    # CFL dt (reference sw2d.py:225 formula at the rest state)
    c = float(np.sqrt(9.81 * (H0 + amp)))
    fs = float(np.abs(np.asarray(ctx.fscale)).max())
    dt = 0.6 / (((N + 1) ** 2) * 0.5 * fs * c)
    print(f"dt = {dt:.4f} s")

    rhs = lambda s, t: sw2d_curved_rhs(ctx, cub, gauss, s, t, phys,
                                       tidal_forcing=tidal)
    fac = (1.0 / (1.0 + dt * phys.sponge)).astype(dtype)

    @jax.jit
    def chunk(s, t):
        def body(carry, _):
            st, tt = carry
            st = ssprk2_step(rhs, st, tt, dt)
            st = SWStateTracer(h=H0 + (st.h - H0) * fac, hu=st.hu * fac,
                               hv=st.hv * fac, hN=st.hN * fac)
            return (st, tt + dt), None

        (s, t), _ = jax.lax.scan(body, (s, t), None, length=100)
        return s, t

    mass0 = float(jnp.sum(cub.W * (state.h @ cub.V.T)))
    t = jnp.asarray(0.0, dtype)
    t_wall = time.perf_counter()
    n_chunks = int(os.environ.get("BLITZDG_CHUNKS", "10"))
    for i in range(n_chunks):
        state, t = chunk(state, t)
        eta_max = float(jnp.max(jnp.abs(state.h - H0)))
        spd = float(jnp.max(jnp.abs(state.hu / state.h)))
        print(f"step={100 * (i + 1):5d} t={float(t):8.1f} s  "
              f"eta_max={eta_max:.4f}  u_max={spd:.4f}")
        if not np.isfinite(eta_max):
            raise SystemExit("instability detected")
    wall = time.perf_counter() - t_wall
    mass1 = float(jnp.sum(cub.W * (state.h @ cub.V.T)))
    print(f"mass drift (tidal arc open): {abs(mass1 - mass0) / mass0:.3e}")
    print(f"{100 * n_chunks} steps in {wall:.2f}s "
          f"({1e3 * wall / (100 * n_chunks):.2f} ms/step)")
    print("done: stable to t=%.1f s" % float(t))


if __name__ == "__main__":
    main()
