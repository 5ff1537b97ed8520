#!/usr/bin/env python
"""Viscous Burgers demo driver — analog of the reference burgers1d
executable (src/burgers1d/main.cpp): N=6, K=40, nu=0.1, c=0.5, CFL=0.75,
LDG auxiliary variable, exact tanh traveling-wave boundary data; prints the
final max-norm error."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax import build_nodes1d
from blitzdg_jax.ops import burgers1d_rhs, burgers_exact
from blitzdg_jax.timestepping import integrate, lserk4_step


def main():
    N, K = 6, 40
    nu, c, alpha, CFL, T = 0.1, 0.5, 1.0, 0.75, 0.1
    ctx = build_nodes1d(N, K, -5.0, 5.0, dtype=jnp.float32)
    x = np.asarray(ctx.x)
    min_dx = x[0, 1] - x[0, 0]
    dt = CFL * min(min_dx / abs(c), min_dx**2 / np.sqrt(nu))
    steps = int(np.ceil(T / dt))

    u0 = burgers_exact(ctx.x, 0.0, alpha, nu, c)
    rhs = lambda u, t: burgers1d_rhs(ctx, u, t, c=c, alpha=alpha, nu=nu)
    u = jax.jit(lambda v: integrate(lserk4_step, rhs, v, 0.0, dt, steps))(u0)

    exact = burgers_exact(ctx.x, steps * dt, alpha, nu, c)
    err = float(jnp.max(jnp.abs(u - exact)))
    print(f"steps={steps} t_final={steps * dt:.4f}")
    print(f"Error: {err:.6e}")


if __name__ == "__main__":
    main()
