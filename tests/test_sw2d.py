"""2D shallow-water solver tests (sw2d-simple configuration analog:
src/sw2d-simple/main.cpp:33-177 — box mesh, N=1..3, Gaussian eta bump,
wall BCs, SSP-RK2 + modal filter)."""
import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sw2d import (
    SWPhysics,
    SWState,
    apply_filter,
    sw2d_rhs,
    sw2d_timestep,
)
from blitzdg_jax.specgrid.triangle import build_triangle_context
from blitzdg_jax.timestepping import ssprk2_step


def make_problem(N=1, cells=4):
    mesh = box_triangles(cells, cells)
    ctx = build_triangle_context(N, mesh, filter_cutoff=0.9 * N, filter_order=N)
    phys = SWPhysics(g=9.81)
    eta = jnp.exp(-10.0 * (ctx.x**2) - 10.0 * (ctx.y**2))
    h = 10.0 + eta
    state = SWState(h=h, hu=jnp.zeros_like(h), hv=jnp.zeros_like(h))
    return ctx, phys, state


def mass(ctx, h):
    V = np.asarray(ctx.V)
    M = np.linalg.inv(V @ V.T)
    w = M.sum(axis=0)  # quadrature weights on the reference element
    return float(np.sum(w[None, :] * np.asarray(ctx.J) * np.asarray(h)))


def test_rhs_zero_for_lake_at_rest():
    """Flat free surface + zero momentum must be an exact steady state."""
    ctx, phys, _ = make_problem(N=2)
    state = SWState(
        h=jnp.full((ctx.k_elem, ctx.n_p), 10.0),
        hu=jnp.zeros((ctx.k_elem, ctx.n_p)),
        hv=jnp.zeros((ctx.k_elem, ctx.n_p)),
    )
    rhs = sw2d_rhs(ctx, state, 0.0, phys)
    np.testing.assert_allclose(np.asarray(rhs.h), 0.0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(rhs.hu), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(rhs.hv), 0.0, atol=1e-8)


def _steep_discontinuous_bathymetry(ctx, seed=0):
    """Kinked shelf profile plus steep per-element offsets — the sharpest
    form of elementwise (.oct-style, reference sw2d/main.cpp:486-515)
    bathymetry data: both the value and the slope of H jump across faces."""
    rng = np.random.default_rng(seed)
    H = 10.0 + 5.0 * jnp.abs(ctx.x)
    H = H + jnp.asarray(rng.uniform(0.0, 8.0, size=(ctx.k_elem, 1)))
    Hx, Hy = ctx.grad(H)  # elementwise polynomial derivative
    return H, Hx, Hy


def test_well_balanced_linear_shelf():
    """Lake at rest over a continuous linear shelf: machine-zero RHS."""
    ctx, _, _ = make_problem(N=3)
    H = 10.0 + 5.0 * ctx.x
    Hx, Hy = ctx.grad(H)
    phys = SWPhysics(g=9.81, H=H, Hx=Hx, Hy=Hy)
    state = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    rhs = sw2d_rhs(ctx, state, 0.0, phys)
    scale = 9.81 * 15.0 * 5.0  # g*h*Hx magnitude
    assert float(jnp.max(jnp.abs(rhs.h))) < 1e-12 * scale
    assert float(jnp.max(jnp.abs(rhs.hu))) < 1e-12 * scale
    assert float(jnp.max(jnp.abs(rhs.hv))) < 1e-12 * scale


def test_well_balanced_discontinuous_bathymetry():
    """Lake at rest over steep inter-element-DISCONTINUOUS bathymetry
    (reference intent sw2d/main.cpp:356-368, 419-421): the hydrostatic-
    reconstruction scheme holds machine-zero RHS where the naive bed-slope
    scheme generates spurious currents at the bathymetry jumps."""
    ctx, _, _ = make_problem(N=2)
    H, Hx, Hy = _steep_discontinuous_bathymetry(ctx)
    state = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    scale = float(9.81 * jnp.max(H) * jnp.max(jnp.abs(H)))

    phys = SWPhysics(g=9.81, H=H, Hx=Hx, Hy=Hy, well_balanced=True)
    rhs = sw2d_rhs(ctx, state, 0.0, phys)
    assert float(jnp.max(jnp.abs(rhs.h))) < 1e-12 * scale
    assert float(jnp.max(jnp.abs(rhs.hu))) < 1e-12 * scale
    assert float(jnp.max(jnp.abs(rhs.hv))) < 1e-12 * scale

    naive = SWPhysics(g=9.81, H=H, Hx=Hx, Hy=Hy, well_balanced=False)
    rhs_n = sw2d_rhs(ctx, state, 0.0, naive)
    # the naive LF flux sees the h jumps as waves: O(1) spurious RHS
    assert float(jnp.max(jnp.abs(rhs_n.h))) > 1e-4 * scale


def test_well_balanced_rollout_no_spurious_currents():
    """A resting coastal state over steep discontinuous bathymetry must stay
    at rest through a time-stepped rollout (no filter — the modal filter is
    not well-balance-preserving by construction)."""
    ctx, _, _ = make_problem(N=2)
    H, Hx, Hy = _steep_discontinuous_bathymetry(ctx, seed=1)
    phys = SWPhysics(g=9.81, H=H, Hx=Hx, Hy=Hy)
    state0 = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))

    def rhs(s, t):
        return sw2d_rhs(ctx, s, t, phys)

    @jax.jit
    def run(state):
        def body(carry, _):
            s, t = carry
            dt = sw2d_timestep(ctx, s, phys.g, 0.3)
            return (ssprk2_step(rhs, s, t, dt), t + dt), None

        (s, t), _ = jax.lax.scan(body, (state, 0.0), None, length=100)
        return s, t

    state, t = run(state0)
    assert float(t) > 0
    assert float(jnp.max(jnp.abs(state.h - H))) < 1e-10
    assert float(jnp.max(jnp.abs(state.hu))) < 1e-10
    assert float(jnp.max(jnp.abs(state.hv))) < 1e-10


def test_sw2d_stable_and_conserves_mass():
    ctx, phys, state0 = make_problem(N=1, cells=4)
    cfl = 0.65
    m0 = mass(ctx, state0.h)

    def rhs(s, t):
        return sw2d_rhs(ctx, s, t, phys)

    post = lambda f: apply_filter(ctx, f)

    @jax.jit
    def run(state):
        def body(carry, _):
            s, t = carry
            dt = sw2d_timestep(ctx, s, phys.g, cfl)
            s = ssprk2_step(rhs, s, t, dt, post_stage=post)
            return (s, t + dt), dt

        (s, t), dts = jax.lax.scan(body, (state, 0.0), None, length=200)
        return s, t, dts

    state, t, dts = run(state0)
    h = np.asarray(state.h)
    assert np.all(np.isfinite(h))
    eta_max = float(np.max(np.abs(h - 10.0)))
    assert eta_max < 2.0  # initial bump is 1.0; bounded evolution
    # Mass conservation: DG + reflective walls conserve total volume.
    m1 = mass(ctx, state.h)
    np.testing.assert_allclose(m1, m0, rtol=1e-10)
    assert float(t) > 0


def test_wall_reflection_no_normal_flow():
    """Momentum flux through walls should vanish: start with a bump, check
    the boundary-normal momentum stays ~0 at wall faces after steps."""
    ctx, phys, state0 = make_problem(N=2, cells=3)

    def rhs(s, t):
        return sw2d_rhs(ctx, s, t, phys)

    @jax.jit
    def run(state, dt):
        def body(carry, _):
            s, t = carry
            s = ssprk2_step(rhs, s, t, dt)
            return (s, t + dt), None

        (s, _), _ = jax.lax.scan(body, (state, 0.0), None, length=50)
        return s

    state = run(state0, 1e-3)
    hu = np.asarray(state.hu).reshape(-1)
    hv = np.asarray(state.hv).reshape(-1)
    vb = np.asarray(ctx.vmapB)[np.asarray(ctx.maskB)]
    mb = np.asarray(ctx.mapB)[np.asarray(ctx.maskB)]
    nx = np.asarray(ctx.nx).reshape(-1)[mb]
    ny = np.asarray(ctx.ny).reshape(-1)[mb]
    un = hu[vb] * nx + hv[vb] * ny
    # normal momentum at walls is not identically zero nodally in DG, but
    # must remain small relative to the momentum scale
    scale = max(np.abs(hu).max(), np.abs(hv).max())
    assert np.abs(un).max() < 0.5 * scale


def test_sw2d_differentiable():
    ctx, phys, state0 = make_problem(N=1, cells=3)

    def loss(h0):
        s = SWState(h=h0, hu=jnp.zeros_like(h0), hv=jnp.zeros_like(h0))
        def body(carry, _):
            st, t = carry
            st = ssprk2_step(lambda ss, tt: sw2d_rhs(ctx, ss, tt, phys), st, t, 1e-3)
            return (st, t + 1e-3), None
        (s, _), _ = jax.lax.scan(body, (s, 0.0), None, length=10)
        return jnp.sum((s.h - 10.0) ** 2)

    g = jax.grad(loss)(state0.h)
    assert np.all(np.isfinite(np.asarray(g)))


class TestOracleParity:
    """BASELINE.md north-star parity bar: the framework's sw2d rollout must
    match an INDEPENDENT from-the-book numpy implementation to 1e-6 (x64)
    on the reference sw2d-simple configuration
    (/root/reference/src/sw2d-simple/main.cpp:33-177)."""

    MESH = "/root/reference/input/coarse_box.msh"

    def _framework_rollout(self, n_order, num_steps, cfl=0.65, g=9.81):
        import os

        import pytest

        if not os.path.exists(self.MESH):
            pytest.skip("reference mesh unavailable")
        from blitzdg_jax.mesh.gmsh import read_gmsh

        mesh = read_gmsh(self.MESH)
        ctx = build_triangle_context(
            n_order, mesh, filter_cutoff=0.9 * n_order, filter_order=n_order
        )
        eta = jnp.exp(-10.0 * ctx.x**2 - 10.0 * ctx.y**2)
        state = SWState(h=10.0 + eta, hu=jnp.zeros_like(eta), hv=jnp.zeros_like(eta))
        phys = SWPhysics(g=g)

        def rhs(s, t):
            return sw2d_rhs(ctx, s, t, phys)

        post = lambda f: apply_filter(ctx, f)

        @jax.jit
        def run(state):
            def body(carry, _):
                s, t = carry
                dt = sw2d_timestep(ctx, s, phys.g, cfl)
                s = ssprk2_step(rhs, s, t, dt, post_stage=post)
                return (s, t + dt), None

            (s, t), _ = jax.lax.scan(body, (state, 0.0), None, length=num_steps)
            return s, t

        return ctx, run(state)

    def _check(self, n_order, num_steps):
        from oracle.sw2d_oracle import run_config

        ctx, (state, t) = self._framework_rollout(n_order, num_steps)
        o, h, hu, hv, t_o = run_config(self.MESH, n_order=n_order,
                                       num_steps=num_steps)
        # same mesh/node layout precondition (element-major vs column-major)
        np.testing.assert_allclose(np.asarray(ctx.x), o.x.T, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ctx.y), o.y.T, atol=1e-12)
        # the 1e-6 control-parity bar (BASELINE.json north star), x64
        np.testing.assert_allclose(float(t), t_o, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(state.h), h.T, atol=1e-6)
        np.testing.assert_allclose(np.asarray(state.hu), hu.T, atol=1e-6)
        np.testing.assert_allclose(np.asarray(state.hv), hv.T, atol=1e-6)

    def test_coarse_box_n1_parity(self):
        """The literal reference config: N=1, CFL=0.65, Gaussian eta."""
        self._check(n_order=1, num_steps=60)

    def test_coarse_box_n3_parity(self):
        """Higher order on the same mesh — exercises warp-and-blend nodes,
        multi-node faces (vmapP permutations) and the non-trivial filter."""
        self._check(n_order=3, num_steps=25)


def test_dense_path_full_coastal_matches_sw2d_rhs():
    """Round-4: the dense path implements the full coastal physics (the r3
    NotImplementedError guard is GONE) — well-balanced star fluxes, tidal
    BC_OUT forcing, bed-slope/drag/Coriolis — and must match sw2d_rhs
    exactly for the same SWPhysics."""
    from blitzdg_jax.ops.sw2d_dense import build_dense_trace_ops, sw2d_rhs_dense

    ctx, _, state = make_problem(N=2)
    rng = np.random.default_rng(3)
    H = 10.0 + 2.0 * jnp.abs(ctx.x) + jnp.asarray(
        rng.uniform(0.0, 3.0, size=(ctx.k_elem, 1)))
    Hx, Hy = ctx.grad(H)
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy)
    # a non-trivial moving state over the bathymetry
    state = SWState(h=H + 0.3 * jnp.exp(-5.0 * (ctx.x**2 + ctx.y**2)),
                    hu=0.2 * jnp.ones_like(H), hv=-0.1 * jnp.ones_like(H))
    ops = build_dense_trace_ops(ctx)
    ref = sw2d_rhs(ctx, state, 0.0, phys)
    out = sw2d_rhs_dense(ctx, ops, state, 0.0, phys)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-11, atol=1e-11)
    # lake at rest stays machine-zero through the dense WB flux too
    rest = SWState(h=H, hu=jnp.zeros_like(H), hv=jnp.zeros_like(H))
    r = sw2d_rhs_dense(ctx, ops, rest, 0.0, phys)
    scale = float(9.81 * jnp.max(H) * jnp.max(jnp.abs(H)))
    assert float(jnp.max(jnp.abs(r.h))) < 1e-12 * scale
    assert float(jnp.max(jnp.abs(r.hu))) < 1e-12 * scale
