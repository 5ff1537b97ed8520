"""End-to-end 1D advection: matches the reference solver's configuration and
error semantics (src/advec1d/main.cpp:35-122): N=4, K=30, x in [-1,4],
c=0.1, CFL=0.8, T=20, Gaussian initial condition, LSERK4."""
import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.ops.advec1d import advec1d_rhs
from blitzdg_jax.specgrid.nodes1d import build_nodes1d
from blitzdg_jax.timestepping import integrate, lserk4_step


def reference_config():
    ctx = build_nodes1d(4, 30, -1.0, 4.0)
    c = 0.1
    CFL = 0.8
    x = np.asarray(ctx.x)
    min_dx = x[0, 1] - x[0, 0]
    dt = CFL * min_dx / abs(c)
    return ctx, c, dt


def test_advec1d_rhs_zero_for_constant_zero():
    ctx, c, _ = reference_config()
    u = jnp.zeros((ctx.k_elem, ctx.n_p))
    rhs = advec1d_rhs(ctx, u, 0.0, c)
    np.testing.assert_allclose(np.asarray(rhs), 0.0)


def test_advec1d_gaussian_transport_error():
    """Full run to T=20; the advected Gaussian must match the exact shifted
    solution with the same kind of small max-norm error the reference
    reports (spectral accuracy at N=4, K=30)."""
    ctx, c, dt = reference_config()
    u0 = jnp.exp(-10.0 * ctx.x**2)

    num_steps = int(np.ceil(20.0 / dt))
    t_final = num_steps * dt

    rhs = lambda u, t: advec1d_rhs(ctx, u, t, c)
    step = jax.jit(lambda u: integrate(lserk4_step, rhs, u, 0.0, dt, num_steps))
    u = step(u0)

    exact = jnp.exp(-10.0 * (ctx.x - c * t_final) ** 2)
    err = float(jnp.max(jnp.abs(u - exact)))

    # Non-circular parity (BASELINE.md 1e-6 bar): tests/oracle/advec1d_oracle
    # is an INDEPENDENT from-the-book numpy nodal-DG implementation (no
    # blitzdg_jax imports) of the reference config #1
    # (advec1d/main.cpp:38-48, error semantics :113-119). The framework
    # solution must match the oracle's full final solution to 1e-6, and the
    # discretization error itself must stay spectrally small.
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from oracle.advec1d_oracle import run_reference_config

    x_o, u_o, err_o = run_reference_config()
    np.testing.assert_allclose(np.asarray(ctx.x), x_o, atol=1e-12)
    assert np.max(np.abs(np.asarray(u) - u_o)) < 1e-6, \
        f"solution drifted from the independent oracle"
    assert abs(err - err_o) < 1e-6
    assert err < 5e-4  # spectral accuracy upper bound (loose)


def test_advec1d_convergence():
    """Error decreases with polynomial order (spectral convergence)."""
    errs = []
    for N in [2, 4, 6]:
        ctx = build_nodes1d(N, 20, -1.0, 4.0)
        c = 0.1
        x = np.asarray(ctx.x)
        dt = 0.5 * (x[0, 1] - x[0, 0]) / abs(c)
        steps = int(np.ceil(5.0 / dt))
        u0 = jnp.exp(-10.0 * ctx.x**2)
        rhs = lambda u, t: advec1d_rhs(ctx, u, t, c)
        u = integrate(lserk4_step, rhs, u0, 0.0, dt, steps)
        exact = jnp.exp(-10.0 * (ctx.x - c * steps * dt) ** 2)
        errs.append(float(jnp.max(jnp.abs(u - exact))))
    assert errs[1] < errs[0] * 0.2
    assert errs[2] < errs[1]


def test_advec1d_batched_scenarios():
    """vmap over scenario batch (the MPC 'DP' axis) must agree with the
    unbatched solve per scenario."""
    ctx, c, dt = reference_config()
    shifts = jnp.array([0.0, 0.5, 1.0, 1.5])
    u0 = jax.vmap(lambda s: jnp.exp(-10.0 * (ctx.x - s) ** 2))(shifts)

    rhs = lambda u, t: advec1d_rhs(ctx, u, t, c)
    roll = lambda u: integrate(lserk4_step, rhs, u, 0.0, dt, 50)
    batched = jax.jit(jax.vmap(roll))(u0)
    single = roll(u0[2])
    np.testing.assert_allclose(np.asarray(batched[2]), np.asarray(single), atol=1e-12)
