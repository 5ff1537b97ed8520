#!/usr/bin/env python
"""Incompressible Boussinesq demo on quads — analog of the reference ins2d
executable (src/ins2d/main.cpp): namelist-driven configuration
(main.cpp:58-102), density advection + momentum with buoyancy source
(computeRHS main.cpp:268-432), and — unlike the reference, whose pressure
factorization is built but never applied — an actually-applied Chorin
pressure projection via mean-deflated Neumann Poisson CG solves.

Stably stratified box with a density perturbation launches internal
gravity waves; prints kinetic energy and max divergence per chunk.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from blitzdg_jax.config import namelist_get, read_namelist
from blitzdg_jax.mesh import box_quads
from blitzdg_jax.ops.ins2d import INSState, divergence, ins2d_step
from blitzdg_jax.specgrid.quad import build_quad_context


def main():
    nml_path = os.path.join(os.path.dirname(__file__), "ins2d.nml")
    cfg = read_namelist(nml_path)
    g = namelist_get(cfg, "gravitationalAcceleration", float, 9.81)
    t = namelist_get(cfg, "initialTime", float, 0.0)
    t_final = namelist_get(cfg, "finalTime", float, 0.2)
    N = namelist_get(cfg, "polynomialOrder", int, 2)
    filt_nc = namelist_get(cfg, "filterCutoff", float, 1.5)
    filt_s = namelist_get(cfg, "filterOrder", int, 4)

    ctx = build_quad_context(N, box_quads(6, 6), filter_cutoff=filt_nc,
                             filter_order=filt_s)
    print(f"K={ctx.k_elem} quads, N={N}, g={g}, T=[{t}, {t_final}]")

    rho = 0.01 * jnp.exp(-8.0 * (ctx.x**2 + ctx.y**2))
    state = INSState(rho=rho, u=jnp.zeros_like(rho), v=jnp.zeros_like(rho))

    dt = 2e-3
    steps = int(round((t_final - t) / dt))
    for i in range(steps):
        state, p = ins2d_step(ctx, state, t + i * dt, dt, g=g)
        if (i + 1) % max(steps // 5, 1) == 0:
            ke = float(jnp.sum(state.u**2 + state.v**2))
            div = float(jnp.max(jnp.abs(divergence(ctx, state.u, state.v))))
            print(f"step={i + 1} t={t + (i + 1) * dt:.4f} "
                  f"KE={ke:.6e} max|div u|={div:.3e}")

    for name, f in zip(state._fields, state):
        if not np.all(np.isfinite(np.asarray(f))):
            raise RuntimeError(f"non-finite field {name}")
    if float(jnp.max(jnp.abs(state.u))) > 1.0:
        raise RuntimeError("velocity blow-up")
    print("done: stable")


if __name__ == "__main__":
    main()
