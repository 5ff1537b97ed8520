"""Quadrilateral discretization tests (reference QuadNodesProvisionerTests
analog) + shallow water on quads (sw2dquads.py analog)."""
import jax
import jax.numpy as jnp
import numpy as np

from blitzdg_jax.mesh import box_quads
from blitzdg_jax.ops.sw2d import SWPhysics, SWState, sw2d_rhs
from blitzdg_jax.specgrid.quad import (
    build_quad_context,
    dmatrices_quad,
    quad_nodes,
    vandermonde_quad,
)
from blitzdg_jax.timestepping import ssprk2_step


class TestQuadOperators:
    def test_nodes_count(self):
        r, s = quad_nodes(3)
        assert r.size == 16
        assert np.isclose(r.min(), -1) and np.isclose(s.max(), 1)

    def test_vandermonde_orthonormal_mass(self):
        r, s = quad_nodes(4)
        V = vandermonde_quad(4, r, s)
        M = np.linalg.inv(V @ V.T)
        # total mass = area of [-1,1]^2 = 4
        np.testing.assert_allclose(M.sum(), 4.0, rtol=1e-12)

    def test_dmatrices_exact_on_polynomials(self):
        for N in [1, 3]:
            r, s = quad_nodes(N)
            V = vandermonde_quad(N, r, s)
            Dr, Ds, _, _ = dmatrices_quad(N, r, s, V)
            for p in range(N + 1):
                for q in range(N + 1):
                    u = r**p * s**q
                    dudr = p * r ** max(p - 1, 0) * s**q if p else 0 * r
                    duds = q * r**p * s ** max(q - 1, 0) if q else 0 * r
                    np.testing.assert_allclose(Dr @ u, dudr, atol=1e-10)
                    np.testing.assert_allclose(Ds @ u, duds, atol=1e-10)


class TestQuadContext:
    def test_geometry_and_area(self):
        ctx = build_quad_context(2, box_quads(4, 4))
        J = np.asarray(ctx.J)
        assert np.all(J > 0)
        V = np.asarray(ctx.V)
        M = np.linalg.inv(V @ V.T)
        area = float(np.sum(M.sum(axis=0)[None, :] * J))
        np.testing.assert_allclose(area, 4.0, rtol=1e-12)

    def test_maps_match_coordinates(self):
        ctx = build_quad_context(3, box_quads(3, 5))
        x = np.asarray(ctx.x).reshape(-1)
        y = np.asarray(ctx.y).reshape(-1)
        vm = np.asarray(ctx.vmapM).reshape(-1)
        vp = np.asarray(ctx.vmapP).reshape(-1)
        np.testing.assert_allclose(x[vm], x[vp], atol=1e-12)
        np.testing.assert_allclose(y[vm], y[vp], atol=1e-12)

    def test_normals_unit_outward(self):
        ctx = build_quad_context(2, box_quads(2, 2))
        nx, ny = np.asarray(ctx.nx), np.asarray(ctx.ny)
        np.testing.assert_allclose(nx**2 + ny**2, 1.0, atol=1e-12)
        x, y = np.asarray(ctx.x), np.asarray(ctx.y)
        fm = np.asarray(ctx.fmask).reshape(-1)
        cx, cy = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
        dot = nx * (x[:, fm] - cx) + ny * (y[:, fm] - cy)
        assert np.all(dot > 0)

    def test_grad_linear_exact(self):
        ctx = build_quad_context(3, box_quads(3, 3))
        u = 2.0 * ctx.x - 1.5 * ctx.y
        ux, uy = ctx.grad(u)
        np.testing.assert_allclose(np.asarray(ux), 2.0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(uy), -1.5, atol=1e-10)


def test_sw2d_on_quads_conserves_mass():
    """The sw2d RHS is element-shape agnostic: run it on quads
    (reference sw2dquads.py analog) and check stability + conservation."""
    ctx = build_quad_context(1, box_quads(4, 4), filter_cutoff=0.9, filter_order=1)
    phys = SWPhysics(g=9.81)
    eta = jnp.exp(-10.0 * (ctx.x**2 + ctx.y**2))
    state = SWState(h=10.0 + eta, hu=jnp.zeros_like(eta), hv=jnp.zeros_like(eta))

    V = np.asarray(ctx.V)
    M = np.linalg.inv(V @ V.T)
    w = M.sum(axis=0)
    mass0 = float(np.sum(w[None, :] * np.asarray(ctx.J) * np.asarray(state.h)))

    @jax.jit
    def run(s):
        def body(carry, _):
            st, t = carry
            st = ssprk2_step(lambda ss, tt: sw2d_rhs(ctx, ss, tt, phys), st, t, 1e-3)
            return (st, t + 1e-3), None

        (s2, _), _ = jax.lax.scan(body, (s, 0.0), None, length=100)
        return s2

    out = run(state)
    h = np.asarray(out.h)
    assert np.all(np.isfinite(h))
    mass1 = float(np.sum(w[None, :] * np.asarray(ctx.J) * h))
    np.testing.assert_allclose(mass1, mass0, rtol=1e-10)
