"""MPC problem definition: controlled DG rollouts + quadratic costs.

The north-star capability (BASELINE.json): batched shooting MPC whose
dynamics model is the nodal-DG shallow-water discretization. The reference
has no MPC layer — this is new machinery built on the
differentiable `sw2d_rhs` dynamics:

 - controls are a (horizon, n_controls) sequence entering the dynamics
   through a user-supplied ``control_to_forcing`` map (e.g. tidal boundary
   amplitude, distributed momentum source);
 - a rollout is one `lax.scan` over the horizon (fixed dt — adaptive
   stepping is deliberately not used inside MPC so step count is static and
   the scan differentiates cleanly, SURVEY.md §7.3);
 - scenario batching is a leading vmap axis over initial states/targets —
   thousands of independent shooting problems per device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import struct
from ..context import DGContext2D
from ..ops.sw2d import SWPhysics, SWState, apply_filter, sw2d_rhs
from ..ops.sw2d_dense import DenseTraceOps, sw2d_rhs_dense
from ..timestepping import ssprk2_step


@struct.dataclass
class MPCProblem:
    """Shooting MPC over the shallow-water dynamics."""

    ctx: DGContext2D
    phys: SWPhysics
    dt: float = struct.field(static=True)
    horizon: int = struct.field(static=True)  # control steps
    steps_per_control: int = struct.field(static=True, default=1)
    # weights
    q_eta: float = struct.field(static=True, default=1.0)
    q_terminal: float = struct.field(static=True, default=10.0)
    r_control: float = struct.field(static=True, default=1e-3)
    use_filter: bool = struct.field(static=True, default=True)
    # dense-trace fast path (wall-only BCs, small meshes): trace extraction
    # as batched matmuls instead of gathers — build with `build_dense_trace_ops`
    dense_ops: DenseTraceOps | None = None
    # rematerialize each inner step in the backward pass: the per-step
    # residuals of these tiny ops cost more in HBM round-trips than the
    # recompute FLOPs (~1.4x faster fwd+bwd at the bench shapes)
    remat: bool = struct.field(static=True, default=True)
    # custom dynamics: rhs_fn(state, t) -> state-like RHS. Overrides the
    # built-in sw2d paths — e.g. the curved weak-form dynamics
    # (ops.sw2d_curved.sw2d_curved_rhs closed over cub/gauss contexts) for
    # the BASELINE stretch config "batched MPC over curved dynamics". The
    # state may carry extra fields (e.g. the hN tracer); costs only read
    # state.h, and the control forcing enters h/hu/hv.
    rhs_fn: Callable | None = struct.field(static=True,
                                                default=None)


def _controlled_rhs(
    prob: MPCProblem, control: jnp.ndarray, control_to_forcing: Callable
):
    """RHS with the control injected as a momentum/elevation forcing."""

    def rhs(state: SWState, t):
        if prob.rhs_fn is not None:
            base = prob.rhs_fn(state, t)
        elif prob.dense_ops is not None:
            base = sw2d_rhs_dense(prob.ctx, prob.dense_ops, state, t, prob.phys)
        else:
            base = sw2d_rhs(prob.ctx, state, t, prob.phys)
        fh, fhu, fhv = control_to_forcing(prob.ctx, control, state, t)
        return base._replace(h=base.h + fh, hu=base.hu + fhu,
                             hv=base.hv + fhv)

    return rhs


def rollout_controls(
    prob: MPCProblem,
    state0: SWState,
    controls: jnp.ndarray,  # (horizon, n_controls)
    control_to_forcing: Callable,
) -> tuple[SWState, SWState]:
    """Roll the dynamics over the horizon; returns (final state, trajectory
    of per-control-step states stacked on a leading axis)."""
    post = (lambda f: apply_filter(prob.ctx, f)) if prob.use_filter else None

    def control_step(carry, control):
        state, t = carry
        rhs = _controlled_rhs(prob, control, control_to_forcing)

        def inner(carry2, _):
            s, tt = carry2
            s = ssprk2_step(rhs, s, tt, prob.dt, post_stage=post)
            return (s, tt + prob.dt), None

        if prob.remat:
            inner = jax.checkpoint(inner)

        (state, t), _ = jax.lax.scan(
            inner, (state, t), None, length=prob.steps_per_control
        )
        return (state, t), state

    (final, _), traj = jax.lax.scan(
        control_step, (state0, jnp.asarray(0.0, dtype=state0.h.dtype)), controls
    )
    return final, traj


def mpc_cost(
    prob: MPCProblem,
    state0: SWState,
    controls: jnp.ndarray,
    target_eta: jnp.ndarray,  # (K, Np) desired surface elevation
    control_to_forcing: Callable,
    H_rest: jnp.ndarray | float = 10.0,
) -> jnp.ndarray:
    """Quadratic tracking cost: running + terminal elevation error in the
    mass-weighted norm, plus control effort."""
    ctx = prob.ctx
    M = ctx.Vinv.T @ ctx.Vinv
    w = (M @ jnp.ones((ctx.n_p,), dtype=ctx.J.dtype))  # row sums = quad weights

    def eta_err_sq(state):
        err = (state.h - H_rest) - target_eta
        return jnp.sum(w[None, :] * ctx.J * err * err)

    final, traj = rollout_controls(prob, state0, controls, control_to_forcing)
    running = jnp.sum(jax.vmap(eta_err_sq)(traj)) / prob.horizon
    terminal = eta_err_sq(final)
    effort = jnp.sum(controls * controls)
    return prob.q_eta * running + prob.q_terminal * terminal + prob.r_control * effort
