"""Viscous Burgers (LDG) end-to-end vs. the exact traveling wave.

Reference config (src/burgers1d/main.cpp:31-44): N=6, K=40, x in [-5,5],
nu=0.1, c=0.5, CFL=0.75, T=0.1, LSERK4.
"""
import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.ops.burgers1d import burgers1d_rhs, burgers_exact
from blitzdg_jax.specgrid.nodes1d import build_nodes1d
from blitzdg_jax.timestepping import integrate, lserk4_step


def test_burgers1d_traveling_wave():
    N, K = 6, 40
    nu, c, alpha, CFL = 0.1, 0.5, 1.0, 0.75
    ctx = build_nodes1d(N, K, -5.0, 5.0)
    x = np.asarray(ctx.x)
    min_dx = x[0, 1] - x[0, 0]
    dt = CFL * min(min_dx / abs(c), min_dx**2 / np.sqrt(nu))

    t_final = 0.1
    num_steps = int(np.ceil(t_final / dt))

    u0 = burgers_exact(ctx.x, 0.0, alpha, nu, c)
    rhs = lambda u, t: burgers1d_rhs(ctx, u, t, c=c, alpha=alpha, nu=nu)
    u = jax.jit(lambda v: integrate(lserk4_step, rhs, v, 0.0, dt, num_steps))(u0)

    t_end = num_steps * dt
    exact = burgers_exact(ctx.x, t_end, alpha, nu, c)
    err = float(jnp.max(jnp.abs(u - exact)))

    # Non-circular parity (BASELINE.md 1e-6 bar): the independent
    # from-the-book numpy LDG oracle (tests/oracle/burgers1d_oracle.py, no
    # package imports) runs reference config #2 (burgers1d/main.cpp:31-60,
    # error semantics :109-112); the framework must match ITS full final
    # solution to 1e-6 (observed agreement: ~1e-15).
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent / "oracle"))
    from burgers1d_oracle import run_reference_config

    x_o, u_o, err_o, t_o = run_reference_config()
    np.testing.assert_allclose(np.asarray(ctx.x), x_o, atol=1e-12)
    assert abs(t_end - t_o) < 1e-12
    assert np.max(np.abs(np.asarray(u) - u_o)) < 1e-6
    assert abs(err - err_o) < 1e-6
    assert err < 1e-5  # spectral accuracy upper bound (loose)


def test_burgers1d_differentiable():
    """The rollout must be differentiable (MPC requirement): gradient of a
    terminal cost w.r.t. the initial condition exists and is finite."""
    ctx = build_nodes1d(4, 10, -5.0, 5.0)
    dt = 1e-3

    def loss(u0):
        rhs = lambda u, t: burgers1d_rhs(ctx, u, t)
        u = integrate(lserk4_step, rhs, u0, 0.0, dt, 5)
        return jnp.sum(u**2)

    u0 = burgers_exact(ctx.x, 0.0, 1.0, 0.1, 0.5)
    g = jax.grad(loss)(u0)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0
