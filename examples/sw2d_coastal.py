#!/usr/bin/env python
"""Full coastal shallow-water demo — analog of the reference sw2d
executable (src/sw2d/main.cpp): variable bathymetry, tidal open-boundary
forcing, quadratic bottom drag, Coriolis, sponge-layer relaxation near the
open boundary, SSP-RK2 + modal filter.

Domain: box with an open (tidal) east boundary and walls elsewhere;
bathymetry shoals linearly toward the west (reference uses .oct depth data
clipped at 150 m — here a parametric shelf profile).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax.context import BC_OUT, BC_WALL
from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sw2d import (
    SWPhysics,
    SWState,
    apply_filter,
    sponge_relax,
    sw2d_rhs,
    sw2d_timestep,
)
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step
from blitzdg_jax.utils import build_sponge_coefficient, instability_guard


def main():
    N = 1
    L = 10_000.0  # 10 km box
    mesh = box_triangles(16, 16, xlim=(0.0, L), ylim=(0.0, L))

    # tag the east boundary open (tidal), everything else wall
    mids_x = 0.5 * (
        mesh.verts[mesh.etov][:, :, 0] + mesh.verts[mesh.etov[:, [1, 2, 0]]][:, :, 0]
    )
    bc = mesh.bc_type.copy()
    bc[(bc > 0) & (np.abs(mids_x - L) < 1.0)] = BC_OUT
    mesh.set_bc_type(bc)

    ctx = build_triangle_context(N, mesh, filter_cutoff=0.9 * N, filter_order=N,
                                 dtype=jnp.float32)

    # shelf bathymetry: 150 m offshore (east) shoaling to 10 m at the coast
    H = (10.0 + (150.0 - 10.0) * ctx.x / L).astype(jnp.float32)
    Hx = jnp.full_like(H, (150.0 - 10.0) / L)
    Hy = jnp.zeros_like(H)

    # sponge near the open boundary
    ob_mask = np.asarray(ctx.bc_table)[:, :, None].repeat(ctx.n_fp, 2).reshape(
        ctx.k_elem, -1
    ) == BC_OUT
    sponge = build_sponge_coefficient(ctx, ob_mask, width=0.15 * L, strength=1e-3)

    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy,
                     sponge=sponge)

    amp, omega = 0.5, 2.0 * np.pi / (12.42 * 3600.0)  # M2 tide

    def tidal_forcing(t):
        ramp = jnp.minimum(t / (2.0 * 3600.0), 1.0)
        HM = 150.0  # offshore depth at the open boundary
        return HM + amp * jnp.cos(omega * t) * ramp

    state = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))

    rhs = lambda s, t: sw2d_rhs(ctx, s, t, phys, tidal_forcing=tidal_forcing)
    post = lambda f: apply_filter(ctx, f)

    @jax.jit
    def chunk(state, t):
        def body(carry, _):
            s, tt = carry
            dt = sw2d_timestep(ctx, s, phys.g, cfl=0.25)
            s = ssprk2_step(rhs, s, tt, dt, post_stage=post)
            s = sponge_relax(s, phys, dt)
            return (s, tt + dt), None

        (s, t), _ = jax.lax.scan(body, (state, t), None, length=200)
        return s, t

    t = jnp.float32(0.0)
    sim_hours = 0.0
    for i in range(10):
        state, t = chunk(state, t)
        eta = state.h - H
        eta_max = float(jnp.max(jnp.abs(eta)))
        spd = float(jnp.max(jnp.abs(state.hu / state.h)))
        sim_hours = float(t) / 3600.0
        print(f"t={sim_hours:.2f}h eta_max={eta_max:.4f}m max|u|={spd:.4f}m/s")
        if bool(instability_guard(state.h, state.hu, state.hv)):
            raise RuntimeError("numerical instability")
    print(f"done: simulated {sim_hours:.2f} tidal hours, stable")


if __name__ == "__main__":
    main()
