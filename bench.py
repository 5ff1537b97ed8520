#!/usr/bin/env python
"""Headline benchmark: coastal sw2d MPC solves/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra",
"device"}; progress lines go to stderr. Refuses to run without a GPU.

One "MPC solve" = a full shooting optimization (20 Adam iterations) of a
control sequence over the shallow-water DG dynamics of the coastal headline
configuration shared with chip_smoke.py: box_triangles(4, 5) (K=40, the
stand-in for the reference coarse_box mesh), N=1, shelf bathymetry with
well-balanced fluxes, drag, Coriolis and a tidal BC_OUT, horizon 8 x 4
SSP-RK2 steps, B=2048 scenarios, `solve_mpc` vmapped over scenarios.

The reference publishes no numbers (BASELINE.md) and has no MPC layer, so
the baseline is a single-threaded numpy model of the same solve: the
measured cost of one numpy forward rollout times the rollouts an adjoint
gradient method needs (iters * (1 forward + ~2x-forward adjoint)). This is
charitable to the CPU (it assumes a perfect hand-written adjoint).

Extra metrics:
 - dg_rollouts_per_s_K2048_N3: the XLA scan rollout at K=2048/N=3, B=8,
   timed over 2048 steps, expressed per 32-step MPC horizon;
 - poisson2d_*: block-Jacobi CG on the SIP Poisson operator on
   box_triangles(16, 16) (K=512, N=2), one right-hand side and 64 batched,
   beside host `splu` on the same assembled triplets;
 - curved_mpc_solves_per_s: batched shooting MPC over the curved weak-form
   dynamics (K=54, N=3, B=256).
"""
import json
import sys
import time

import numpy as np

import chip_smoke as cs

N_MEAS = 2048  # steps of the timed large-mesh rollout


def _phase(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def best_time(fn, *args, reps=3):
    """Least wall time of ``reps`` calls after one warm-up call."""
    cs.timed(fn, *args)
    return min(cs.timed(fn, *args)[1] for _ in range(reps))


def numpy_forward_rollout_time(ctx, dt, n_steps, reps=5, coastal=None):
    """Single-threaded numpy SSP-RK2 sw2d rollout (the CPU reference model).
    Mirrors the reference computeRHS data flow (gathers + flux algebra +
    BLAS GEMMs) in plain numpy, f64, one scenario.

    ``coastal``: optional dict(H, Hx, Hy, cd, f_cor, tidal, obc) adding the
    full reference sw2d physics (src/sw2d/main.cpp:279-484) — hydrostatic-
    reconstruction star fluxes over bathymetry, bed-slope source, quadratic
    drag, Coriolis, tidal BC_OUT forcing — so the CPU model does the SAME
    work as the coastal headline solve."""
    K = ctx.k_elem
    n_tr = ctx.n_faces * ctx.n_fp
    Dr, Ds = np.asarray(ctx.Dr), np.asarray(ctx.Ds)
    lift = np.asarray(ctx.lift)
    rx, sx = np.asarray(ctx.rx), np.asarray(ctx.sx)
    ry, sy = np.asarray(ctx.ry), np.asarray(ctx.sy)
    nx, ny = np.asarray(ctx.nx).reshape(-1), np.asarray(ctx.ny).reshape(-1)
    fscale = np.asarray(ctx.fscale)
    filt = np.asarray(ctx.filter)
    vmapM = np.asarray(ctx.vmapM).reshape(-1)
    vmapP = np.asarray(ctx.vmapP).reshape(-1)
    wall = np.asarray(ctx.mapB)[np.asarray(ctx.maskB)]
    g = 9.81

    x = np.asarray(ctx.x, np.float64)
    if coastal is not None:
        Hb = np.asarray(coastal["H"], np.float64)
        Hbx, Hby = np.asarray(coastal["Hx"]), np.asarray(coastal["Hy"])
        cd, f_cor = coastal["cd"], coastal["f_cor"]
        h0_t, amp_t, om_t, tau_t = coastal["tidal"]
        obc = np.asarray(coastal["obc"])  # flat trace indices
        HbM = Hb.reshape(-1)[vmapM]
        HbP = Hb.reshape(-1)[vmapP]
        h = Hb.copy()
    else:
        h = 10.0 + np.exp(-10.0 * (x**2))
    hu = np.zeros_like(h)
    hv = np.zeros_like(h)

    def rhs(h, hu, hv, t):
        out = []
        hf, huf, hvf = h.reshape(-1), hu.reshape(-1), hv.reshape(-1)
        hM, hP = hf[vmapM], hf[vmapP].copy()
        huM, huP = huf[vmapM], huf[vmapP].copy()
        hvM, hvP = hvf[vmapM], hvf[vmapP].copy()
        un2 = 2.0 * (huM[wall] * nx[wall] + hvM[wall] * ny[wall])
        huP[wall] = huM[wall] - un2 * nx[wall]
        hvP[wall] = hvM[wall] - un2 * ny[wall]

        def flux(hh, hhu, hhv):
            inv = 1.0 / hh
            return (hhu, hhu * hhu * inv + 0.5 * g * hh * hh, hhu * hhv * inv,
                    hhv, hhu * hhv * inv, hhv * hhv * inv + 0.5 * g * hh * hh)

        if coastal is not None:
            # tidal open boundary + star-variable well-balancing
            ramp = min(t / tau_t, 1.0) if tau_t > 0 else 1.0
            hP[obc] = h0_t + amp_t * np.cos(om_t * t) * ramp
            uM, vM = huM / hM, hvM / hM
            uP, vP = huP / hP, hvP / hP
            bstar = np.maximum(-HbM, -HbP)
            hMs = np.maximum(0.0, hM - HbM - bstar)
            hPs = np.maximum(0.0, hP - HbP - bstar)
            corr = (hM - hMs) * (uM * nx + vM * ny)

            def flux_uv(hh, uu, vv):
                pr = 0.5 * g * hh * hh
                return (hh * uu, hh * uu * uu + pr, hh * uu * vv,
                        hh * vv, hh * uu * vv, hh * vv * vv + pr)

            F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(hMs, uM, vM)
            F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(hPs, uP, vP)
            spdM = np.sqrt(uM * uM + vM * vM) + np.sqrt(g * hMs)
            spdP = np.sqrt(uP * uP + vP * vP) + np.sqrt(g * hPs)
            dh, dhu, dhv = hMs - hPs, F1M - F1P, G1M - G1P
        else:
            F1M, F2M, F3M, G1M, G2M, G3M = flux(hM, huM, hvM)
            F1P, F2P, F3P, G1P, G2P, G3P = flux(hP, huP, hvP)
            spdM = np.sqrt((huM / hM) ** 2 + (hvM / hM) ** 2) + np.sqrt(g * hM)
            spdP = np.sqrt((huP / hP) ** 2 + (hvP / hP) ** 2) + np.sqrt(g * hP)
            dh, dhu, dhv = hM - hP, huM - huP, hvM - hvP
            corr = None
        lam = np.maximum(spdM, spdP).reshape(-1, ctx.n_fp).max(axis=1, keepdims=True)
        lam = np.broadcast_to(lam, (lam.shape[0], ctx.n_fp)).reshape(-1)
        d1 = 0.5 * ((F1M - F1P) * nx + (G1M - G1P) * ny - lam * dh)
        d2 = 0.5 * ((F2M - F2P) * nx + (G2M - G2P) * ny - lam * dhu)
        d3 = 0.5 * ((F3M - F3P) * nx + (G3M - G3P) * ny - lam * dhv)
        if corr is not None:
            d1, d2, d3 = d1 + corr, d2 + corr * uM, d3 + corr * vM
        F1, F2, F3, G1, G2, G3 = flux(h, hu, hv)
        div = lambda F, G: (rx * (F @ Dr.T) + sx * (F @ Ds.T)
                            + ry * (G @ Dr.T) + sy * (G @ Ds.T))
        surf = lambda d: (fscale * d.reshape(K, n_tr)) @ lift.T
        out.append(-div(F1, G1) + surf(d1))
        out.append(-div(F2, G2) + surf(d2))
        out.append(-div(F3, G3) + surf(d3))
        if coastal is not None:
            u, v = hu / h, hv / h
            nrm = np.sqrt(u * u + v * v)
            out[1] += g * h * Hbx - cd * nrm * u + f_cor * hv
            out[2] += g * h * Hby - cd * nrm * v - f_cor * hu
        return [o @ filt.T for o in out]

    def one_rollout():
        t0 = time.perf_counter()
        hh, huu, hvv = h.copy(), hu.copy(), hv.copy()
        t = 0.0
        for _ in range(n_steps):
            r1, r2, r3 = rhs(hh, huu, hvv, t)
            h1, hu1, hv1 = hh + 0.5 * dt * r1, huu + 0.5 * dt * r2, hvv + 0.5 * dt * r3
            r1, r2, r3 = rhs(h1, hu1, hv1, t + 0.5 * dt)
            hh, huu, hvv = hh + dt * r1, huu + dt * r2, hvv + dt * r3
            t += dt
        assert np.isfinite(hh).all(), "baseline rollout went non-finite"
        return time.perf_counter() - t0

    one_rollout()  # warm caches
    # best-of-N: the baseline is a lower bound on the CPU cost
    return min(one_rollout() for _ in range(reps))


def headline(extra, batch=cs.B_HEADLINE):
    """Coastal MPC solves/s on the GPU and the numpy CPU model of it."""
    from blitzdg_jax.context import BC_OUT

    _phase("setup: headline coastal MPC")
    cfg = cs.headline_config(batch)
    ctx, phys, prob = cfg["ctx"], cfg["phys"], cfg["prob"]
    solve = cs.compile_fn("headline solve", cs.xla_solve_fn(cfg),
                          cfg["states"], cfg["targets"])
    _phase("run: headline coastal MPC")
    (cost, cost0), _ = cs.timed(solve, cfg["states"], cfg["targets"])
    assert np.all(np.isfinite(np.asarray(cost))), "MPC solve non-finite"
    solves_per_s = batch / best_time(solve, cfg["states"], cfg["targets"])
    extra["headline_cost_decrease_median"] = float(
        np.median(np.asarray(cost0) / np.asarray(cost)))

    obc = np.asarray(ctx.bc_maps.idx[BC_OUT])[
        np.asarray(ctx.bc_maps.mask[BC_OUT])]
    coastal = {"H": phys.H, "Hx": phys.Hx, "Hy": phys.Hy, "cd": phys.cd,
               "f_cor": phys.f_cor, "tidal": cs.TIDE, "obc": obc}
    fwd = numpy_forward_rollout_time(ctx, prob.dt, cs.HORIZON * cs.SPC,
                                     coastal=coastal)
    cpu_solves_per_s = 1.0 / (cs.ITERS * 3.0 * fwd)
    return solves_per_s, cpu_solves_per_s


def large_rollout(extra, batch=8, cells=32):
    import jax
    import jax.numpy as jnp

    _phase("setup+run: XLA scan rollout K=2048 N=3")
    ctx, phys, state, dt = cs.large_mesh(cells=cells)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          state)
    roll = cs.compile_fn(f"{N_MEAS}-step rollout",
                         cs.rollout_fn(ctx, phys, dt, N_MEAS), states)
    out, _ = cs.timed(roll, states)
    assert bool(jnp.all(jnp.isfinite(out.h))), "rollout went non-finite"
    step_s = best_time(roll, states) / (N_MEAS * batch)
    horizon = cs.HORIZON * cs.SPC
    extra["dg_step_us_K2048_N3"] = 1e6 * step_s
    extra["dg_rollouts_per_s_K2048_N3"] = 1.0 / (horizon * step_s)
    cpu_rollout = numpy_forward_rollout_time(ctx, dt, horizon, reps=3)
    extra["dg_rollouts_vs_baseline"] = cpu_rollout / (horizon * step_s)


def elliptic(extra, n_batch=64, cells=16):
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from blitzdg_jax.ops.poisson import apply_mass
    from blitzdg_jax.solvers.krylov import CONV_SUCCESS, cg

    _phase("setup+run: SIP Poisson block-Jacobi CG")
    ctx, mv, op, precon, b = cs.poisson_setup(cells)
    one = cs.compile_fn("cg", lambda b: cg(mv, b, tol=cs.CG_TOL, maxiter=2000,
                                           precon=precon), b)
    res, _ = cs.timed(one, b)
    assert int(res.flag) == CONV_SUCCESS, int(res.flag)
    extra["poisson2d_cg_ms"] = 1e3 * best_time(one, b)
    extra["poisson2d_cg_iters"] = int(res.iters)

    rng = np.random.default_rng(0)
    offs = rng.uniform(-0.5, 0.5, size=(n_batch, 2))
    bs = jnp.stack([apply_mass(ctx, 2.0 * np.pi ** 2
                               * jnp.sin(np.pi * (ctx.x - ox))
                               * jnp.sin(np.pi * (ctx.y - oy))).reshape(-1)
                    for ox, oy in offs]).astype(jnp.float32)
    batched = cs.compile_fn("batched cg", jax.vmap(
        lambda b: cg(mv, b, tol=cs.CG_TOL, maxiter=2000, precon=precon)), bs)
    res_b, _ = cs.timed(batched, bs)
    extra[f"poisson2d_batched{n_batch}_ms_per_rhs"] = (
        1e3 * best_time(batched, bs) / n_batch)
    # these shifted right-hand sides sit at the float32 residual floor of
    # the operator (~2e-4): the flags say how many met the tolerance on
    # the true residual; the splu comparison below checks the solutions
    extra[f"poisson2d_batched{n_batch}_converged"] = int(
        np.sum(np.asarray(res_b.flag) == CONV_SUCCESS))
    extra[f"poisson2d_batched{n_batch}_relres_max"] = float(
        np.max(np.asarray(res_b.relres)))

    t0 = time.perf_counter()
    lu = spla.splu(op.tocsc())
    extra["poisson2d_splu_factor_ms"] = 1e3 * (time.perf_counter() - t0)
    bh = np.asarray(bs, np.float64)
    t0 = time.perf_counter()
    xs = np.stack([lu.solve(v) for v in bh])
    extra["poisson2d_splu_solve_ms_per_rhs"] = (
        1e3 * (time.perf_counter() - t0) / n_batch)
    extra["poisson2d_batched_vs_splu_rel"] = cs.rel_err(res_b.x, xs)
    assert extra["poisson2d_batched_vs_splu_rel"] < 1e-3


def curved(extra, batch=256):
    _phase("setup+run: curved MPC")
    extra["curved_mpc_solves_per_s"] = cs.phase_curved(batch)


def main():
    import jax

    cs.log = _phase  # stdout carries only the result line
    devices = jax.devices()
    cs.require_gpu(devices)
    from blitzdg_jax.config import enable_compile_cache

    enable_compile_cache()
    _phase(f"{devices[0].device_kind}; nvidia-smi: {cs.nvidia_smi()}")
    extra = {}
    value, cpu = headline(extra)
    large_rollout(extra)
    elliptic(extra)
    curved(extra)
    print(json.dumps({
        "metric": "sw2d_mpc_solves_per_s_per_chip",
        "value": value,
        "unit": "solves/s",
        "vs_baseline": value / cpu,
        "extra": extra,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": 1},
    }))


if __name__ == "__main__":
    main()
