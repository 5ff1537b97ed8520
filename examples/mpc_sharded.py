"""Element-sharded MPC over the ppermute-halo XLA rollout (parallel/halo.py).

An Adam loop optimizes a per-step control sequence (two Gaussian momentum
sources) to steer the flow to a target terminal momentum field, with
`jax.grad` flowing through the element-sharded rollout: halo exchange by
`ppermute` between SSP-RK2 stages, cost reduced with `psum`. The target is
the terminal momentum reached by a hidden reference control sequence, so
it is reachable.

    python examples/mpc_sharded.py                  # all local devices
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/mpc_sharded.py              # virtual CPU devices
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_jax.config import enable_compile_cache
from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sw2d import SWPhysics, SWState, apply_filter
from blitzdg_jax.parallel import (
    build_halo_plan,
    context_shard_specs,
    halo_sw2d_rhs,
    halo_tables,
    partition_mesh,
)
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step


def main(ndev=None, n_steps=8, iters=30, dt=1e-3):
    enable_compile_cache()
    devices = jax.devices()
    ndev = ndev or min(8, len(devices))
    mesh2d, _, _ = partition_mesh(box_triangles(8, 8), ndev)
    ctx = build_triangle_context(1, mesh2d, filter_cutoff=0.9,
                                 filter_order=1, dtype=jnp.float32)
    phys = SWPhysics(g=9.81)
    plan = build_halo_plan(ctx, ndev)
    tables = halo_tables(plan)
    el_mesh = Mesh(np.array(devices[:ndev]), ("element",))
    el2 = P("element", None)
    tb_specs = tuple(P("element", *([None] * (a.ndim - 1))) for a in tables)

    def terminal_hu(c, tb, cs):
        bump = jnp.exp(-8.0 * (c.x ** 2 + c.y ** 2))
        h = jnp.full_like(c.x, 10.0)  # rest start: the controls steer
        s = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))

        def body(s, ctrl):
            def rhs(ss, t):
                r = halo_sw2d_rhs(c, ss, t, phys, tb, plan)
                return r._replace(hu=r.hu + ctrl[0] * bump,
                                  hv=r.hv + ctrl[1] * bump)
            return ssprk2_step(rhs, s, 0.0, dt,
                               post_stage=lambda f: apply_filter(c, f)), None

        return jax.lax.scan(body, s, cs)[0].hu

    roll = jax.jit(jax.shard_map(
        terminal_hu, mesh=el_mesh,
        in_specs=(context_shard_specs(ctx), tb_specs, P()), out_specs=el2))
    cs_ref = jnp.asarray(np.array([[0.8, -0.4]] * n_steps, np.float32))
    target = roll(ctx, tables, cs_ref)

    def loss_local(c, tb, cs, tgt):
        err = jnp.sum((terminal_hu(c, tb, cs) - tgt) ** 2)
        return jax.lax.psum(err, "element") + 1e-7 * jnp.sum(cs ** 2)

    total = jax.shard_map(
        loss_local, mesh=el_mesh,
        in_specs=(context_shard_specs(ctx), tb_specs, P(), el2),
        out_specs=P())
    vg = jax.jit(jax.value_and_grad(
        lambda cs: total(ctx, tables, cs, target)))
    opt = optax.adam(0.5)
    cs = jnp.zeros((n_steps, 2), jnp.float32)
    state = opt.init(cs)
    v0 = None
    for i in range(iters):
        v, g = vg(cs)
        upd, state = opt.update(g, state, cs)
        cs = optax.apply_updates(cs, upd)
        v0 = float(v) if v0 is None else v0
        if i % 10 == 0 or i == iters - 1:
            print(f"iter {i:3d}: cost {float(v):.6f}", flush=True)
    vf = float(vg(cs)[0])
    print(f"cost {v0:.6f} -> {vf:.6f} ({vf / v0:.3f}x) over {ndev} shards on "
          f"{devices[0].platform}")
    print(f"recovered controls (step 0): {np.asarray(cs[0])} "
          f"vs reference {np.asarray(cs_ref[0])}")
    assert vf < 0.05 * v0, "optimization failed to reduce the cost"


if __name__ == "__main__":
    main()
