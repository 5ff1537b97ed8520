#!/usr/bin/env python
"""Smoke test of the system's main paths on NVIDIA GPUs.

    python chip_smoke.py               # one card: every one-card phase
    python chip_smoke.py --devices 4   # four cards: the sharded phase only

One-card phases, in order:
 1. device: refuses anything but a GPU; prints its kind, name and power
    limit;
 2. headline MPC: batched coastal shooting MPC (K=40, N=1, B=2048, horizon
    8 x 4 SSP-RK2 steps, 20 Adam iterations), `solve_mpc` vmapped over
    scenarios: trajectory and gradient against the same program on the
    host CPU backend, final costs of the dense-trace RHS against the gather
    RHS, compile time, solves/s, memory; both solves timed in turns;
 3. large-mesh rollout: K=2048, N=3, B=8 through the XLA scan, against the
    same program on the host CPU backend, and mass conservation over
    2048 steps;
 4. elliptic: the SIP Poisson operator solved with block-Jacobi CG against
    host `splu` on the same assembled triplets;
 5. curved MPC: K=54, B=256, Adam through `solve_mpc` over the curved
    weak-form dynamics.
With ``--devices 4`` only the sharded phase runs: scenario-sharded MPC
value-and-gradient, element-sharded halo rollout and halo-sharded CG, each
against its one-card result.

Every phase prints its own lines; any failure ends the run with a non-zero
exit code and no result line. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

B_HEADLINE = 2048
HORIZON, SPC, ITERS, LR = 8, 4, 20, 0.05
TIDE = (12.0, 0.2, 2.0, 0.02)  # h0, amp, omega, ramp_tau
# DG matmul algorithms of the trajectory check, each with its bound
TRAJ_ALGOS = (("F32_F32_F32", 1e-4), ("TF32_TF32_F32_X3", 1e-3))


def log(msg):
    print(msg, flush=True)


def require_gpu(devices, count=1):
    """Exit non-zero unless ``devices`` holds at least ``count`` GPUs."""
    plats = sorted({d.platform for d in devices})
    if plats != ["gpu"] or len(devices) < count:
        log(f"[device] FAIL: need {count} GPU device(s), JAX found "
            f"{len(devices)} on platform(s) {plats}")
        raise SystemExit(2)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    import jax
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def compile_fn(name, fn, *args):
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    log(f"  {name}: compile {secs:.3f} s; memory_analysis {mem}")
    return compiled


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def check(name, value, bound):
    ok = bool(value <= bound)
    log(f"  {name}: {value:.3e} (bound {bound:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value} exceeds {bound}")


# ---------------------------------------------------------------------------
# headline configuration: coastal MPC on box_triangles(4, 5), K=40, N=1
# ---------------------------------------------------------------------------

def headline_config(batch=B_HEADLINE):
    import jax
    import jax.numpy as jnp

    from blitzdg_jax.context import BC_OUT
    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.mpc import MPCProblem
    from blitzdg_jax.ops.sw2d import SWPhysics, SWState, sw2d_rhs
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    mesh = box_triangles(4, 5)
    xmax = float(mesh.verts[:, 0].max())
    bc = np.asarray(mesh.bc_type).copy()
    for k in range(mesh.num_elements):
        for f in range(3):
            a, b = mesh.etov[k, f], mesh.etov[k, (f + 1) % 3]
            mx = 0.5 * (mesh.verts[a, 0] + mesh.verts[b, 0])
            if bc[k, f] > 0 and abs(mx - xmax) < 1e-9:
                bc[k, f] = BC_OUT  # tidal open boundary on the east side
    mesh.set_bc_type(bc)
    ctx = build_triangle_context(1, mesh, filter_cutoff=0.9, filter_order=1,
                                 dtype=jnp.float32)
    # shelf: 8 m at the west wall to 12 m at the open east side
    xmin = float(mesh.verts[:, 0].min())
    span = xmax - xmin
    H = (8.0 + 4.0 * (ctx.x - xmin) / span).astype(jnp.float32)
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=(4.0 / span) * jnp.ones_like(H), Hy=jnp.zeros_like(H))
    h0, amp, omega, tau = TIDE

    def tide(t):
        return h0 + amp * jnp.cos(omega * t) * jnp.minimum(t / tau, 1.0)

    # CFL-limited dt at the deepest tidal state
    c = float(np.sqrt(9.81 * (h0 + 2.0 * amp)))
    dt = 0.7 / (4 * 0.5 * float(np.abs(np.asarray(ctx.fscale)).max()) * c)
    prob = MPCProblem(
        ctx=ctx, phys=phys, dt=dt, horizon=HORIZON, steps_per_control=SPC,
        q_eta=0.0, q_terminal=1.0, r_control=1e-10,
        rhs_fn=lambda s, t: sw2d_rhs(ctx, s, t, phys, tidal_forcing=tide))
    bump = jnp.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2)).astype(jnp.float32)

    def forcing(c_, control, state, t):
        return jnp.zeros_like(state.h), control[0] * bump, control[1] * bump

    rest = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          rest)
    offs = jnp.linspace(-0.3, 0.3, batch, dtype=jnp.float32)
    targets = jax.vmap(lambda o: 1e-3 * jnp.exp(
        -5.0 * ((ctx.x - o) ** 2 + ctx.y ** 2)))(offs).astype(jnp.float32)
    return dict(ctx=ctx, phys=phys, prob=prob, tide=tide, bump=bump,
                forcing=forcing, states=states, targets=targets, H=H)


def xla_solve_fn(cfg, dense=False, iters=ITERS):
    """Batched plain-XLA Adam solve: `solve_mpc` vmapped over scenarios,
    over the gather RHS (ops/sw2d.py) or the dense-trace RHS
    (ops/sw2d_dense.py). Returns (final cost, first-iteration cost)."""
    import jax

    from blitzdg_jax.mpc import solve_mpc
    from blitzdg_jax.ops.sw2d_dense import build_dense_trace_ops, sw2d_rhs_dense

    prob, ctx, phys, tide = cfg["prob"], cfg["ctx"], cfg["phys"], cfg["tide"]
    if dense:
        ops = build_dense_trace_ops(ctx)
        prob = prob.replace(rhs_fn=lambda s, t: sw2d_rhs_dense(
            ctx, ops, s, t, phys, tidal_forcing=tide))

    def solve(states, targets):
        sol = jax.vmap(lambda s, tg: solve_mpc(
            prob, s, tg, cfg["forcing"], 2, iters=iters, learning_rate=LR,
            H_rest=cfg["H"]))(states, targets)
        return sol.cost, sol.cost_history[:, 0]

    return solve


def on_host(fn, *args):
    """Run ``fn`` jitted on the host CPU backend: the float32 reference the
    GPU results are compared with."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.jit(fn)(*jax.device_put(args, cpu))


def phase_headline(B=B_HEADLINE, iters=ITERS):
    import jax
    import jax.numpy as jnp

    from blitzdg_jax import config
    from blitzdg_jax.mpc import mpc_cost, rollout_controls

    log(f"[mpc] coastal shooting MPC: K=40 N=1 B={B} horizon "
        f"{HORIZON}x{SPC} steps, {iters} Adam iterations, plain XLA")
    cfg = headline_config(B)
    prob, states, targets = cfg["prob"], cfg["states"], cfg["targets"]
    ctrls = 0.5 * jax.random.normal(jax.random.PRNGKey(0), (B, HORIZON, 2),
                                    jnp.float32)

    # (a) 32-step forward trajectory, every step, against the host reference
    prob1 = prob.replace(horizon=HORIZON * SPC, steps_per_control=1)

    def traj(states, ctrls):
        return jax.vmap(lambda s, c: rollout_controls(
            prob1, s, jnp.repeat(c, SPC, axis=0), cfg["forcing"])[1].h
        )(states, ctrls)

    ref_h = on_host(traj, states, ctrls)
    for algo, bound in TRAJ_ALGOS:
        # the DG ops read the precision while tracing: a fresh function
        # per algorithm keeps jit from reusing another algorithm's trace
        config.set_matmul_precision(algo)
        try:
            err = rel_err(jax.jit(lambda s, c: traj(s, c))(states, ctrls),
                          ref_h)
        finally:
            config.set_matmul_precision("highest")
        check(f"trajectory max|dh|/max|h| vs host float32 ({algo})", err,
              bound)

    # (b) gradient of the summed cost w.r.t. the controls
    def total(c, states, targets):
        return jnp.sum(jax.vmap(lambda s, cc, tg: mpc_cost(
            prob, s, cc, tg, cfg["forcing"], cfg["H"]))(states, c, targets))

    grad = jax.grad(total)
    check("cost gradient max|dg|/max|g| vs host float32 (F32_F32_F32)",
          rel_err(jax.jit(grad)(ctrls, states, targets),
                  on_host(grad, ctrls, states, targets)), 1e-3)

    # (c) full solves over the gather RHS and the dense-trace RHS
    fns = {"xla_gather": compile_fn("solve, gather RHS",
                                    xla_solve_fn(cfg, iters=iters),
                                    states, targets),
           "xla_dense": compile_fn("solve, dense-trace RHS",
                                   xla_solve_fn(cfg, True, iters),
                                   states, targets)}
    costs = {}
    for name, fn in fns.items():
        (c, c0), _ = timed(fn, states, targets)
        c, c0 = np.asarray(c), np.asarray(c0)
        assert np.all(np.isfinite(c)), name
        frac = float(np.mean(c < c0))
        log(f"  {name} cost: first {np.median(c0):.6e} -> final "
            f"{np.median(c):.6e} (median); decreased in {frac:.4f} of "
            "scenarios")
        assert np.median(c / c0) < 1.0 and frac >= 0.99, name
        costs[name] = c
    check("final cost |median(dense/gather) - 1|",
          abs(float(np.median(costs["xla_dense"] / costs["xla_gather"]))
              - 1.0), 1e-2)

    # timing in turns: gather, dense, dense, gather
    times = {name: [] for name in fns}
    for name in ("xla_gather", "xla_dense", "xla_dense", "xla_gather"):
        times[name].append(timed(fns[name], states, targets)[1])
    for name, ts in times.items():
        best = min(ts)
        log(f"  {name}: solve {best:.4f} s (runs {['%.4f' % t for t in ts]}),"
            f" {B / best:.1f} solves/s")


# ---------------------------------------------------------------------------
# large-mesh rollout, elliptic, curved MPC
# ---------------------------------------------------------------------------

def large_mesh(n_order=3, cells=32):
    import jax.numpy as jnp

    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.ops.sw2d import SWPhysics, SWState
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    ctx = build_triangle_context(n_order, box_triangles(cells, cells),
                                 filter_cutoff=0.9 * n_order, filter_order=4,
                                 dtype=jnp.float32)
    h = 10.0 + jnp.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))
    state = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))
    c = float(np.sqrt(9.81 * 11.0))
    dt = 0.7 / ((n_order + 1) ** 2 * 0.5
                * float(np.abs(np.asarray(ctx.fscale)).max()) * c)
    return ctx, SWPhysics(g=9.81), state, dt


def rollout_fn(ctx, phys, dt, n_steps):
    import jax

    from blitzdg_jax.ops.sw2d import apply_filter, sw2d_rhs
    from blitzdg_jax.timestepping import ssprk2_step

    def one(state):
        def body(s, _):
            s = ssprk2_step(lambda ss, t: sw2d_rhs(ctx, ss, t, phys), s, 0.0,
                            dt, post_stage=lambda f: apply_filter(ctx, f))
            return s, None

        return jax.lax.scan(body, state, None, length=n_steps)[0]

    return jax.vmap(one)


def phase_large_mesh(batch=8, cells=32, long_steps=2048):
    import jax
    import jax.numpy as jnp

    ctx, phys, state, dt = large_mesh(cells=cells)
    log(f"[large] K={ctx.k_elem} N=3 B={batch} rollout through the XLA scan")
    states = jax.tree.map(
        lambda a: a[None] * jnp.linspace(1.0, 1.01, batch,
                                         dtype=a.dtype)[:, None, None], state)
    gpu = compile_fn("64-step rollout", rollout_fn(ctx, phys, dt, 64), states)
    out, secs = timed(gpu, states)
    out, secs = timed(gpu, states)
    log(f"  64 steps: {secs * 1e6 / (64 * batch):.3f} us/step/scenario")
    ref = on_host(rollout_fn(ctx, phys, dt, 64), states)
    check("GPU vs host-CPU backend max|dh|/max|h| after 64 steps (float32, "
          "'highest')", rel_err(out.h, ref.h), 1e-5)

    w = (ctx.Vinv.T @ ctx.Vinv) @ jnp.ones((ctx.n_p,), jnp.float32)
    mass = jax.jit(lambda h: jnp.sum(w[None, None, :] * ctx.J[None] * h,
                                     axis=(1, 2)))
    long = compile_fn(f"{long_steps}-step rollout",
                      rollout_fn(ctx, phys, dt, long_steps), states)
    out2, secs = timed(long, states)
    assert bool(jnp.all(jnp.isfinite(out2.h)))
    m0, m1 = np.asarray(mass(states.h)), np.asarray(mass(out2.h))
    log(f"  {long_steps} steps: {secs * 1e6 / (long_steps * batch):.3f} "
        "us/step/scenario")
    check(f"mass drift over {long_steps} steps max|dm|/m", rel_err(m1, m0),
          1e-5)


def poisson_setup(cells=16, n_order=2):
    """The matrix-free SIP operator on box_triangles(cells, cells), its
    assembled triplets (probed column by column on the host CPU backend),
    block-Jacobi blocks and a manufactured right-hand side."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.ops.poisson import apply_mass, poisson2d_op
    from blitzdg_jax.solvers.precon import block_jacobi_precon
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    ctx = build_triangle_context(n_order, box_triangles(cells, cells),
                                 dtype=jnp.float32)
    K, n_p = ctx.k_elem, ctx.n_p

    def mv(v):
        return -poisson2d_op(ctx, v.reshape(K, n_p),
                             symmetrize=True).reshape(-1)

    cols = np.asarray(on_host(jax.vmap(mv), jnp.eye(K * n_p,
                                                    dtype=jnp.float32)))
    op = sp.csr_matrix(cols.T.astype(np.float64))  # row i = (A e_j)_i
    blocks = np.stack([op[k * n_p:(k + 1) * n_p, k * n_p:(k + 1) * n_p]
                       .toarray() for k in range(K)])
    precon = block_jacobi_precon(blocks, jnp.float32)
    f = -2.0 * np.pi ** 2 * jnp.sin(np.pi * ctx.x) * jnp.sin(np.pi * ctx.y)
    b = apply_mass(ctx, -f.astype(jnp.float32)).reshape(-1)
    return ctx, mv, op, precon, b


CG_TOL = 1e-4


def phase_elliptic(cells=16):
    import jax
    import scipy.sparse.linalg as spla

    from blitzdg_jax.solvers.krylov import CONV_SUCCESS, cg

    ctx, mv, op, precon, b = poisson_setup(cells)
    log(f"[elliptic] SIP Poisson, box_triangles({cells}, {cells}) "
        f"K={ctx.k_elem} N=2, block-Jacobi CG tol {CG_TOL:g}, float32, "
        f"{op.nnz} assembled triplets")
    fn = compile_fn("cg", lambda b: cg(mv, b, tol=CG_TOL, maxiter=2000,
                                       precon=precon), b)
    res, secs = timed(fn, b)
    res, secs = timed(fn, b)
    x_host = spla.splu(op.tocsc()).solve(np.asarray(b, np.float64))
    log(f"  flag {int(res.flag)}, iterations {int(res.iters)}, true relres "
        f"{float(res.relres):.3e}, {secs * 1e3:.3f} ms")
    assert int(res.flag) == CONV_SUCCESS, int(res.flag)
    check("CG vs host splu max|dx|/max|x|", rel_err(res.x, x_host), 1e-3)


def phase_curved(batch=256, iters=10):
    import jax
    import jax.numpy as jnp

    from blitzdg_jax.mesh import disk_triangles
    from blitzdg_jax.mesh.curved import (circle_projection,
                                         gordon_hall_deform,
                                         snap_boundary_vertices)
    from blitzdg_jax.mpc import MPCProblem, rollout_controls, solve_mpc
    from blitzdg_jax.ops.sw2d import SWPhysics
    from blitzdg_jax.ops.sw2d_curved import SWStateTracer, sw2d_curved_rhs
    from blitzdg_jax.specgrid.cubature import (build_cubature_context,
                                               build_gauss_face_context)
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    n = 3
    mesh = disk_triangles(3, radius=1.0)
    proj = circle_projection(0.0, 0.0, 1.0)
    cf = snap_boundary_vertices(mesh, proj, tol=0.3)
    c0 = build_triangle_context(n, mesh, dtype=None)
    x2, y2, _ = gordon_hall_deform(n, mesh, c0.x, c0.y, cf, proj)
    ctx = build_triangle_context(n, mesh, coords=(x2, y2),
                                 filter_cutoff=0.9 * n, filter_order=4,
                                 dtype=jnp.float32)
    cub = build_cubature_context(n, mesh, x2, y2, c0.V, dtype=jnp.float32)
    gauss = build_gauss_face_context(n, mesh, x2, y2, c0.V, dtype=jnp.float32)
    log(f"[curved] curved MPC K={ctx.k_elem} N={n} B={batch}, {iters} Adam "
        "iterations")
    phys = SWPhysics(g=9.81)
    c = float(np.sqrt(9.81 * 1.1))
    dt = 0.5 / ((n + 1) ** 2 * 0.5
                * float(np.abs(np.asarray(ctx.fscale)).max()) * c)
    prob = MPCProblem(ctx=ctx, phys=phys, dt=dt, horizon=4,
                      steps_per_control=2, q_eta=0.0, q_terminal=1.0,
                      r_control=1e-10,
                      rhs_fn=lambda s, t: sw2d_curved_rhs(ctx, cub, gauss, s,
                                                          t, phys))
    bump = jnp.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2)).astype(jnp.float32)

    def forcing(c_, control, s, t):
        return jnp.zeros_like(s.h), control[0] * bump, control[1] * bump

    h = jnp.ones((ctx.k_elem, ctx.n_p), jnp.float32)
    s0 = SWStateTracer(h=h, hu=0 * h, hv=0 * h, hN=0 * h)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          s0)
    # reachable targets: the elevation a known, per-scenario scaled control
    # sequence produces
    scale = jnp.linspace(0.5, 1.5, batch, dtype=jnp.float32)
    targets = jax.jit(jax.vmap(lambda a: rollout_controls(
        prob, s0, a * jnp.tile(jnp.array([[0.5, -0.3]], jnp.float32),
                               (prob.horizon, 1)), forcing)[0].h - 1.0))(scale)

    def solve(states, targets):
        with jax.default_matmul_precision("highest"):
            sol = jax.vmap(lambda s, tg: solve_mpc(
                prob, s, tg, forcing, 2, iters=iters, learning_rate=0.1,
                H_rest=1.0))(states, targets)
        return sol.cost, sol.cost_history[:, 0]

    fn = compile_fn("curved solve", solve, states, targets)
    (cost, cost0), secs = timed(fn, states, targets)
    (cost, cost0), secs = timed(fn, states, targets)
    cost, cost0 = np.asarray(cost), np.asarray(cost0)
    assert np.all(np.isfinite(cost))
    frac = float(np.mean(cost < cost0))
    log(f"  cost: first {np.median(cost0):.6e} -> final {np.median(cost):.6e}"
        f" (median), decreased in {frac:.4f} of scenarios; "
        f"{batch / secs:.1f} solves/s")
    assert np.median(cost / cost0) < 1.0 and frac >= 0.99
    return batch / secs


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def on_devices(arr, devices):
    got = {d for s in arr.addressable_shards for d in [s.device]}
    assert got == set(devices), (got, devices)
    return len(got)


def phase_sharded(devs, batch=B_HEADLINE, cells=32):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from blitzdg_jax.mpc import mpc_cost
    from blitzdg_jax.ops.poisson import poisson2d_op
    from blitzdg_jax.ops.sw2d import SWState, apply_filter, sw2d_rhs
    from blitzdg_jax.parallel import (build_halo_plan, context_shard_specs,
                                      halo_poisson2d_op, halo_sw2d_rhs,
                                      halo_tables, partition_mesh)
    from blitzdg_jax.solvers.krylov import cg
    from blitzdg_jax.timestepping import ssprk2_step

    n = len(devs)
    one = devs[0]

    # 1) scenario-sharded MPC value and gradient at the headline width
    log(f"[sharded] scenario-sharded MPC value_and_grad, B={batch} "
        f"over {n} cards")
    cfg = headline_config(batch)
    ctrls = 0.5 * jax.random.normal(jax.random.PRNGKey(0),
                                    (batch, HORIZON, 2), jnp.float32)

    def loss(c, states, targets):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(jax.vmap(lambda cc, s, tg: mpc_cost(
                cfg["prob"], s, cc, tg, cfg["forcing"], cfg["H"]))(
                    c, states, targets))

    vg = jax.jit(jax.value_and_grad(loss))
    args = (ctrls, cfg["states"], cfg["targets"])
    v1, g1 = vg(*jax.device_put(args, one))
    mesh = Mesh(np.array(devs), ("scenario",))
    sh = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(
        mesh, P("scenario", *([None] * (a.ndim - 1))))), args)
    v4, g4 = vg(*sh)
    log(f"  gradient on {on_devices(g4, devs)} devices")
    check("sharded vs one-card cost rel. diff", rel_err(v4, v1), 1e-5)
    check("sharded vs one-card grad max|dg|/max|g|", rel_err(g4, g1), 1e-5)

    # 2) element-sharded halo rollout, K=2048 N=3
    from blitzdg_jax.mesh import box_triangles
    from blitzdg_jax.specgrid.triangle import build_triangle_context

    mesh_el, _, _ = partition_mesh(box_triangles(cells, cells), n)
    log(f"[sharded] element-sharded halo rollout K={mesh_el.num_elements} "
        f"N=3 over {n} cards")
    ctx = build_triangle_context(3, mesh_el, filter_cutoff=2.7,
                                 filter_order=4, dtype=jnp.float32)
    from blitzdg_jax.ops.sw2d import SWPhysics

    phys = SWPhysics(g=9.81)
    h = 10.0 + jnp.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))
    state = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))
    dt = 0.7 / (16 * 0.5 * float(np.abs(np.asarray(ctx.fscale)).max())
                * float(np.sqrt(9.81 * 11.0)))
    n_steps = 64
    post = lambda f: apply_filter(ctx, f)  # noqa: E731

    def ref_run(s):
        def body(s, _):
            return ssprk2_step(lambda ss, t: sw2d_rhs(ctx, ss, t, phys), s,
                               0.0, dt, post_stage=post), None
        with jax.default_matmul_precision("highest"):
            return jax.lax.scan(body, s, None, length=n_steps)[0]

    ref = jax.jit(ref_run)(jax.device_put(state, one))
    plan = build_halo_plan(ctx, n)
    tables = halo_tables(plan)
    el_mesh = Mesh(np.array(devs), ("element",))
    el2 = P("element", None)
    ctx_specs = context_shard_specs(ctx)
    st_specs = jax.tree.map(lambda a: el2, state)
    tb_specs = tuple(P("element", *([None] * (a.ndim - 1))) for a in tables)

    def shard_run(c, s, tb):
        def body(s, _):
            rhs = lambda ss, t: halo_sw2d_rhs(c, ss, t, phys, tb, plan)  # noqa
            return ssprk2_step(rhs, s, 0.0, dt,
                               post_stage=lambda f: apply_filter(c, f)), None
        with jax.default_matmul_precision("highest"):
            return jax.lax.scan(body, s, None, length=n_steps)[0]

    fn = jax.jit(jax.shard_map(shard_run, mesh=el_mesh,
                               in_specs=(ctx_specs, st_specs, tb_specs),
                               out_specs=st_specs))
    out = fn(ctx, state, tables)
    log(f"  state on {on_devices(out.h, devs)} devices")
    check("halo vs one-card max|dh|/max|h| after 64 steps", rel_err(out.h,
                                                                    ref.h),
          1e-5)

    # 3) halo-sharded CG on the same partitioned mesh, N=2
    log(f"[sharded] halo-sharded CG over {n} cards")
    from blitzdg_jax.ops.poisson import apply_mass

    ctx2 = build_triangle_context(2, mesh_el, dtype=jnp.float32)
    tau = float((ctx2.n_order + 1) ** 2 * jnp.max(ctx2.fscale))
    f2 = (-2.0 * np.pi ** 2 * jnp.sin(np.pi * ctx2.x)
          * jnp.sin(np.pi * ctx2.y)).astype(jnp.float32)
    b = -apply_mass(ctx2, f2)
    plan2 = build_halo_plan(ctx2, n)
    tables2 = halo_tables(plan2)
    tb2_specs = tuple(P("element", *([None] * (a.ndim - 1))) for a in tables2)

    def one_cg(bb):
        def mv(v):
            return -poisson2d_op(ctx2, v.reshape(-1, ctx2.n_p), tau,
                                 symmetrize=True).reshape(-1)
        with jax.default_matmul_precision("highest"):
            return cg(mv, bb.reshape(-1), tol=1e-5, maxiter=3000).x

    def sharded_cg(c, bb, tb):
        def mv(v):
            return -halo_poisson2d_op(c, v.reshape(-1, c.n_p), tau, tb, plan2,
                                      symmetrize=True).reshape(-1)
        with jax.default_matmul_precision("highest"):
            res = cg(mv, bb.reshape(-1), tol=1e-5, maxiter=3000,
                     axis_name="element")
        return res.x.reshape(-1, c.n_p), res.relres

    x1 = jax.jit(one_cg)(jax.device_put(b, one))
    cg_fn = jax.jit(jax.shard_map(
        sharded_cg, mesh=el_mesh,
        in_specs=(context_shard_specs(ctx2), el2, tb2_specs),
        out_specs=(el2, P())))
    x4, relres = cg_fn(ctx2, b, tables2)
    log(f"  solution on {on_devices(x4, devs)} devices, true relres "
        f"{float(relres):.3e}")
    check("halo CG vs one-card max|dx|/max|x|", rel_err(x4.reshape(-1), x1),
          1e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    ap.add_argument("--phase", action="append",
                    choices=("mpc", "large", "elliptic", "curved"),
                    help="run only these one-card phases (default: all)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices, args.devices)
    from blitzdg_jax.config import enable_compile_cache

    log(f"[device] {devices[0].device_kind} x{len(devices)}; compile cache "
        f"{enable_compile_cache()}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")

    if args.devices == 4:
        phase_sharded(devices[:4])
    else:
        phases = {"mpc": phase_headline, "large": phase_large_mesh,
                  "elliptic": phase_elliptic, "curved": phase_curved}
        for name in args.phase or phases:
            t0 = time.perf_counter()
            phases[name]()
            log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": args.devices}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
