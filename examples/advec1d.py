#!/usr/bin/env python
"""1D advection demo driver — the user-facing analog of the reference's
advec1d solver (src/advec1d/main.cpp) and advec1d.py numpy driver.

Runs the reference configuration (N=4, K=30, x in [-1,4], c=0.1, CFL=0.8,
T=20) as one jitted rollout and prints the final max-norm error against the
exact advected Gaussian.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from blitzdg_jax import build_nodes1d
from blitzdg_jax.ops import advec1d_rhs
from blitzdg_jax.timestepping import integrate, lserk4_step


def main():
    N, K, c, CFL, T = 4, 30, 0.1, 0.8, 20.0
    ctx = build_nodes1d(N, K, -1.0, 4.0, dtype=jnp.float32)
    x = np.asarray(ctx.x)
    dt = CFL * (x[0, 1] - x[0, 0]) / abs(c)
    num_steps = int(np.ceil(T / dt))
    t_final = num_steps * dt

    u0 = jnp.exp(-10.0 * ctx.x**2)
    rhs = lambda u, t: advec1d_rhs(ctx, u, t, c)
    u = jax.jit(lambda v: integrate(lserk4_step, rhs, v, 0.0, dt, num_steps))(u0)

    exact = jnp.exp(-10.0 * (ctx.x - c * t_final) ** 2)
    err = float(jnp.max(jnp.abs(u - exact)))
    print(f"steps={num_steps} t_final={t_final:.4f}")
    print(f"Error: {err:.6e}")


if __name__ == "__main__":
    main()
