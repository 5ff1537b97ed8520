"""Element-sharding strong-scaling study of the XLA ppermute-halo stepper.

Runs the same element-sharded SSP-RK2 rollout (K=2048, N=3) on 1, 2, 4 and
8 devices (as many as exist) and reports us/step, speedup, efficiency and
the measured halo share of a step: the same program re-traced with the
halo module's `_ppermute` hook patched to identity (identical per-shard
compute, no collectives) gives the no-exchange time. A third run ships the
halo traces in bfloat16.

    python examples/scaling_study.py
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/scaling_study.py   # plumbing check on virtual devices

Set SCALING_JSON=path to append the run payload as JSON.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_jax.config import enable_compile_cache
from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sw2d import SWPhysics, SWState
from blitzdg_jax.parallel import (
    build_halo_plan,
    context_shard_specs,
    halo_sw2d_rhs,
    halo_tables,
    partition_mesh,
)
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step

N_ORDER = 3
CELLS = 32  # K = 2048
N_STEPS = 100
DT = 1e-4


def run_sharded(mesh0, n_dev, devices, no_comm=False, halo_dtype=None):
    """us/step of the element-sharded XLA-halo rollout on n_dev devices.

    ``no_comm=True`` re-traces the SAME program with the halo module's
    injectable `_ppermute` hook patched to identity: identical per-shard
    compute, zero collectives — the timing difference is the measured
    halo cost. ``halo_dtype`` ships compressed trace buffers."""
    from blitzdg_jax.parallel import halo as halo_mod

    mesh2, _, _ = partition_mesh(mesh0, n_dev)
    ctx = build_triangle_context(N_ORDER, mesh2, dtype=jnp.float32)
    plan = build_halo_plan(ctx, n_dev)
    tables = halo_tables(plan)
    el_mesh = Mesh(np.array(devices[:n_dev]), ("element",))
    phys = SWPhysics(g=9.81)

    h = 10.0 + jnp.exp(-10.0 * (ctx.x**2 + ctx.y**2))
    state = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))

    specs = context_shard_specs(ctx)
    st_specs = jax.tree.map(lambda a: P("element", None), state)
    tb_specs = tuple(P("element", *([None] * (a.ndim - 1))) for a in tables)

    def roll(c, s, tb):
        def body(s, _):
            rhs = lambda ss, t: halo_sw2d_rhs(c, ss, t, phys, tb, plan,
                                              halo_dtype=halo_dtype)
            return ssprk2_step(rhs, s, 0.0, DT), None
        s, _ = jax.lax.scan(body, s, None, length=N_STEPS)
        return s

    import contextlib
    from unittest import mock

    fired = {"n": 0}

    def _identity_permute(x, axis_name, perm):
        fired["n"] += 1
        return x

    cm = (mock.patch.object(halo_mod, "_ppermute", _identity_permute)
          if no_comm else contextlib.nullcontext())
    with cm:
        fn = jax.jit(jax.shard_map(
            roll, mesh=el_mesh, in_specs=(specs, st_specs, tb_specs),
            out_specs=st_specs))
        out = fn(ctx, state, tables)
        jax.block_until_ready(out)
        if no_comm:
            assert fired["n"] > 0, "ppermute hook never fired; comm_pct invalid"
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn(ctx, state, tables)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps / N_STEPS, plan


def strong_scaling(out_rows):
    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    mesh0 = box_triangles(CELLS, CELLS)
    print(f"strong scaling (XLA halo), K={2 * CELLS * CELLS}, N={N_ORDER}, "
          f"{N_STEPS} SSP-RK2 steps, platform={devices[0].platform}")
    t1 = None
    for n in counts:
        t, plan = run_sharded(mesh0, n, devices)
        comm_pct = bf16_us = None
        if n > 1:
            t_nc, _ = run_sharded(mesh0, n, devices, no_comm=True)
            comm_pct = round(max(0.0, (t - t_nc) / t) * 100, 1)
            t_bf, _ = run_sharded(mesh0, n, devices, halo_dtype=jnp.bfloat16)
            bf16_us = round(t_bf * 1e6, 1)
        if t1 is None:
            t1 = t
        eff = t1 / (n * t)
        row = {"devices": n, "us_per_step": round(t * 1e6, 1),
               "speedup": round(t1 / t, 3),
               "efficiency_pct": round(eff * 100, 1),
               "comm_pct": comm_pct,
               "us_per_step_bf16_halos": bf16_us}
        out_rows.append(row)
        print(f"  devices={n}: {t * 1e6:8.1f} us/step   "
              f"speedup x{t1 / t:5.2f}   efficiency {eff * 100:5.1f}%"
              + (f"   halo comm {comm_pct:4.1f}% of step"
                 if comm_pct is not None else "")
              + (f"   bf16-halos {bf16_us:.1f} us/step"
                 if bf16_us is not None else ""))
    if devices[0].platform == "cpu":
        print("NOTE: virtual CPU devices share one machine's FLOPs — "
              "efficiencies here validate the plumbing, not the hardware.")


def main():
    enable_compile_cache()
    devices = jax.devices()
    rows = []
    strong_scaling(rows)

    out = os.environ.get("SCALING_JSON")
    if out:
        import json

        payload = {
            "workload": {"N": N_ORDER, "dt": DT, "K": 2 * CELLS * CELLS,
                         "kind": "strong scaling, element-sharded "
                                 "ppermute-halo SSP-RK2"},
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "rows": rows,
        }
        existing = []
        if os.path.exists(out):
            with open(out) as f:
                existing = json.load(f)
        existing.append(payload)
        with open(out, "w") as f:
            json.dump(existing, f, indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
