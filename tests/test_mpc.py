"""MPC layer tests: controlled rollouts, cost reduction, scenario batching,
receding horizon (north-star capability, BASELINE.json)."""
import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.mpc import MPCProblem, mpc_cost, receding_horizon, rollout_controls, solve_mpc
from blitzdg_jax.ops.sw2d import SWPhysics, SWState
from blitzdg_jax.specgrid.triangle import build_triangle_context


def gaussian_source_forcing(ctx, control, state, t):
    """Control = amplitudes of fixed Gaussian momentum sources:
    control[0] drives x-momentum, control[1] drives y-momentum."""
    bump = jnp.exp(-8.0 * (ctx.x**2 + ctx.y**2))
    return jnp.zeros_like(ctx.x), control[0] * bump, control[1] * bump


def make_problem(N=1, cells=3, horizon=5):
    mesh = box_triangles(cells, cells)
    ctx = build_triangle_context(N, mesh, filter_cutoff=0.9 * N, filter_order=N)
    phys = SWPhysics(g=9.81)
    prob = MPCProblem(
        ctx=ctx, phys=phys, dt=2e-3, horizon=horizon, steps_per_control=4,
        q_eta=0.0, q_terminal=1.0, r_control=1e-10,
    )
    h0 = jnp.full((ctx.k_elem, ctx.n_p), 10.0)
    state0 = SWState(h=h0, hu=jnp.zeros_like(h0), hv=jnp.zeros_like(h0))
    return prob, state0


def test_rollout_shapes_and_finiteness():
    prob, state0 = make_problem()
    controls = 0.1 * jnp.ones((prob.horizon, 2))
    final, traj = rollout_controls(prob, state0, controls, gaussian_source_forcing)
    assert traj.h.shape == (prob.horizon, prob.ctx.k_elem, prob.ctx.n_p)
    assert np.all(np.isfinite(np.asarray(final.h)))
    # controls actually move the fluid
    assert float(jnp.max(jnp.abs(final.hu))) > 1e-6


def test_mpc_reduces_cost_and_recovers_reachable_target():
    """Generate the target from a known control sequence, then check the
    optimizer drives the cost well below the zero-control cost."""
    prob, state0 = make_problem(horizon=6)
    c_true = 0.5 * jnp.ones((prob.horizon, 2))
    final_true, _ = rollout_controls(prob, state0, c_true, gaussian_source_forcing)
    target = final_true.h - 10.0  # reachable elevation field

    sol = jax.jit(
        lambda s, tg: solve_mpc(
            prob, s, tg, gaussian_source_forcing, 2, iters=80, learning_rate=0.05
        )
    )(state0, target)
    hist = np.asarray(sol.cost_history)
    assert np.all(np.isfinite(hist))
    assert hist[-1] < hist[0] * 0.05, f"cost did not decrease: {hist[0]} -> {hist[-1]}"
    # recovered first control close to the generating one (non-unique, loose)
    assert abs(float(sol.controls[0, 0]) - 0.5) < 0.25


def test_gn_solver_converges_and_beats_adam_at_equal_rollouts():
    """Gauss-Newton/LM (VERDICT r4 weak #4): on a reachable-target
    shooting problem, a few GN iterations must (a) verify its residual
    formulation (cost == mpc_cost), (b) reach a much lower cost than its
    own start, with a small final gradient norm, and (c) beat Adam when
    Adam is given the same rollout budget (one GN iter costs about
    2*cg_iters + 2 rollout-grade passes vs Adam's 2)."""
    from blitzdg_jax.mpc import solve_mpc_gn
    from blitzdg_jax.mpc.solver import _mpc_residuals

    prob, state0 = make_problem(horizon=6)
    c_true = 0.5 * jnp.ones((prob.horizon, 2))
    final_true, _ = rollout_controls(prob, state0, c_true,
                                     gaussian_source_forcing)
    target = final_true.h - 10.0

    # residual formulation consistency: sum(R^2) == mpc_cost
    c_test = 0.2 * jnp.ones((prob.horizon, 2))
    r = _mpc_residuals(prob, state0, c_test, target,
                       gaussian_source_forcing, 10.0)
    c_ref = mpc_cost(prob, state0, c_test, target,
                     gaussian_source_forcing, 10.0)
    np.testing.assert_allclose(float(jnp.sum(r * r)), float(c_ref),
                               rtol=1e-12)

    GN_ITERS, CG_ITERS = 4, 6
    sol = jax.jit(lambda s, tg: solve_mpc_gn(
        prob, s, tg, gaussian_source_forcing, 2,
        gn_iters=GN_ITERS, cg_iters=CG_ITERS))(state0, target)
    hist = np.asarray(sol.cost_history)
    assert np.all(np.isfinite(hist))
    zero_cost = float(mpc_cost(prob, state0, jnp.zeros((prob.horizon, 2)),
                               target, gaussian_source_forcing, 10.0))
    # the reachable floor is the irreducible r_control effort term
    # (~0.9% of zero_cost here); GN reaches it with a ~machine-zero
    # gradient in 4 outer iterations
    assert float(sol.cost) < 0.02 * zero_cost, (float(sol.cost), zero_cost)
    assert float(sol.grad_norm) < 1e-12

    # equal-rollout-budget Adam: GN spent ~GN_ITERS*(2*CG_ITERS + 3)
    # rollout-grade passes; Adam gets the same number (2 per iter)
    adam_iters = GN_ITERS * (2 * CG_ITERS + 3) // 2
    sol_a = jax.jit(lambda s, tg: solve_mpc(
        prob, s, tg, gaussian_source_forcing, 2, iters=adam_iters,
        learning_rate=0.05))(state0, target)
    assert float(sol.cost) < float(sol_a.cost), (
        float(sol.cost), float(sol_a.cost))


def test_dense_fast_path_matches_gather_path():
    """MPC with dense trace operators (the batched-matmul path) must produce the
    same cost and gradients as the gather-based RHS."""
    from blitzdg_jax.ops.sw2d_dense import build_dense_trace_ops

    prob, state0 = make_problem(horizon=4)
    prob_dense = prob.replace(dense_ops=build_dense_trace_ops(prob.ctx))
    target = 0.05 * jnp.exp(-5.0 * (prob.ctx.x**2 + prob.ctx.y**2))
    controls = 0.3 * jnp.ones((prob.horizon, 2))

    cost_fn = lambda p, c: mpc_cost(p, state0, c, target, gaussian_source_forcing)
    c0, g0 = jax.value_and_grad(lambda c: cost_fn(prob, c))(controls)
    c1, g1 = jax.value_and_grad(lambda c: cost_fn(prob_dense, c))(controls)
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-10)
    # matmul-vs-gather summation order differs; agreement to ~1e-8 relative
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-6)

    # remat must not change values either
    prob_noremat = prob.replace(remat=False)
    c2, g2 = jax.value_and_grad(lambda c: cost_fn(prob_noremat, c))(controls)
    np.testing.assert_allclose(float(c2), float(c0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g0), rtol=1e-12)


def test_mpc_batched_scenarios():
    """vmap over scenarios (different targets) — the DP axis."""
    prob, state0 = make_problem(horizon=4)
    offsets = jnp.array([-0.3, 0.0, 0.3])
    targets = jax.vmap(
        lambda o: 0.05 * jnp.exp(-5.0 * ((prob.ctx.x - o) ** 2 + prob.ctx.y**2))
    )(offsets)
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape), state0)

    solve = jax.jit(
        jax.vmap(
            lambda s, tg: solve_mpc(
                prob, s, tg, gaussian_source_forcing, 2, iters=15, learning_rate=0.05
            )
        )
    )
    sols = solve(states, targets)
    assert sols.controls.shape == (3, prob.horizon, 2)
    assert np.all(np.isfinite(np.asarray(sols.cost)))
    # batched solve of scenario 1 agrees with the single solve
    single = solve_mpc(
        prob, state0, targets[1], gaussian_source_forcing, 2, iters=15,
        learning_rate=0.05,
    )
    np.testing.assert_allclose(
        np.asarray(sols.controls[1]), np.asarray(single.controls), atol=1e-10
    )


def test_receding_horizon_runs():
    prob, state0 = make_problem(horizon=3)
    target = jnp.zeros_like(prob.ctx.x)
    state, applied, costs = jax.jit(
        lambda s: receding_horizon(
            prob, s, target, gaussian_source_forcing, 2, n_cycles=3, iters=5
        )
    )(state0)
    assert applied.shape == (3, 2)
    assert np.all(np.isfinite(np.asarray(state.h)))
