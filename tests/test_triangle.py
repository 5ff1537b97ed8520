"""Golden-value and property tests for the triangle discretization.

Goldens mirror the reference igloo assertions
(src/test/TriangleNodesProvisionerTests.cpp:69-493) — framework-independent
spectral-element math.
"""
import numpy as np
import pytest

from blitzdg_jax.mesh import box_triangles, read_gmsh
from blitzdg_jax.specgrid.triangle import (
    build_triangle_context,
    dmatrices_2d,
    grad_simplex_2d_p,
    lift_2d,
    build_fmask,
    rs_to_ab,
    simplex_2d_p,
    triangle_nodes,
    vandermonde_2d,
    warp_factor,
    xy_to_rs,
)

REF_MESHES = "/root/reference/input"


class TestSimplexBasis:
    def test_simplex_polynomial_golden(self):
        a = np.array([0.1, 0.2, 0.3])
        b = np.array([0.2, 0.3, 0.4])
        p = simplex_2d_p(a, b, 1, 2)
        np.testing.assert_allclose(
            p, [0.133252242007405, 0.355359724434270, 0.637112282097905], atol=1e-13
        )

    def test_rs_to_ab_golden(self):
        r = np.array([-0.1, 0.1, 0.2])
        s = np.array([0.2, 0.3, 0.5])
        a, b = rs_to_ab(r, s)
        np.testing.assert_allclose(a, [1.25, 2.14285714285714, 3.8], atol=1e-13)
        np.testing.assert_allclose(b, s, atol=1e-15)

    def test_xy_to_rs_golden(self):
        x = np.array([0.5, 0.6, 0.7])
        y = np.array([0.2, 0.3, 0.4])
        r, s = xy_to_rs(x, y)
        np.testing.assert_allclose(
            r, [0.0511966128287416, 0.0934615859097789, 0.1357265589908162], atol=1e-13
        )
        np.testing.assert_allclose(
            s, [-0.1023932256574831, 0.0130768281804420, 0.1285468820183672], atol=1e-13
        )

    def test_warp_factor_golden(self):
        # NOrder=3 fixture in the reference tests
        w = warp_factor(3, np.array([-0.1, 0.1, 0.2]))
        np.testing.assert_allclose(
            w,
            [-0.0384345884812357, 0.0384345884812359, 0.0768691769624717],
            atol=1e-13,
        )

    def test_grad_simplex_fd(self):
        r = np.array([-0.5, -0.2, 0.1])
        s = np.array([-0.4, -0.3, -0.6])
        h = 1e-6
        for (i, j) in [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2)]:
            a, b = rs_to_ab(r, s)
            dr, ds = grad_simplex_2d_p(a, b, i, j)
            ar, br = rs_to_ab(r + h, s)
            al, bl = rs_to_ab(r - h, s)
            fd_r = (simplex_2d_p(ar, br, i, j) - simplex_2d_p(al, bl, i, j)) / (2 * h)
            au, bu = rs_to_ab(r, s + h)
            ad, bd = rs_to_ab(r, s - h)
            fd_s = (simplex_2d_p(au, bu, i, j) - simplex_2d_p(ad, bd, i, j)) / (2 * h)
            np.testing.assert_allclose(dr, fd_r, rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(ds, fd_s, rtol=1e-6, atol=1e-8)


class TestTriangleOperators:
    def test_lift_golden_n3(self):
        r, s = triangle_nodes(3)
        V = vandermonde_2d(3, r, s)
        fmask = build_fmask(r, s, 4)
        lift = lift_2d(3, r, s, fmask, V)
        expected = np.array([
            [7., 4.04508, -1.54508, 0.5, -0.833333, -4.16667, -4.16667, -0.833333, 7., 4.04508, -1.54508, 0.5],
            [0.809017, 8., 1.5, -0.309017, 0.259115, 2.26295, 0.0719685, -0.805181, -0.292448, -2.23864, 1.07038, -0.328153],
            [-0.309017, 1.5, 8., 0.809017, -0.292448, -2.23864, 1.07038, -0.328153, 0.259115, 2.26295, 0.0719685, -0.805181],
            [0.5, -1.54508, 4.04508, 7., 7., 4.04508, -1.54508, 0.5, -0.833333, -4.16667, -4.16667, -0.833333],
            [-0.292448, -2.23864, 1.07038, -0.328153, -0.805181, 0.0719685, 2.26295, 0.259115, 0.809017, 8., 1.5, -0.309017],
            [0.0617284, -0.987654, -0.987654, 0.0617284, 0.0617284, -0.987654, -0.987654, 0.0617284, 0.0617284, -0.987654, -0.987654, 0.0617284],
            [-0.328153, 1.07038, -2.23864, -0.292448, 0.809017, 8., 1.5, -0.309017, -0.805181, 0.0719685, 2.26295, 0.259115],
            [0.259115, 2.26295, 0.0719685, -0.805181, -0.328153, 1.07038, -2.23864, -0.292448, -0.309017, 1.5, 8., 0.809017],
            [-0.805181, 0.0719685, 2.26295, 0.259115, -0.309017, 1.5, 8., 0.809017, -0.328153, 1.07038, -2.23864, -0.292448],
            [-0.833333, -4.16667, -4.16667, -0.833333, 0.5, -1.54508, 4.04508, 7., 0.5, -1.54508, 4.04508, 7.],
        ])
        np.testing.assert_allclose(lift, expected, atol=2e-5)

    def test_dmatrices_differentiate_exactly(self):
        for N in [1, 3, 5]:
            r, s = triangle_nodes(N)
            V = vandermonde_2d(N, r, s)
            Dr, Ds, Drw, Dsw = dmatrices_2d(N, r, s, V)
            # differentiate all monomials r^p s^q with p+q <= N exactly
            for p in range(N + 1):
                for q in range(N + 1 - p):
                    u = r**p * s**q
                    dudr = p * r ** max(p - 1, 0) * s**q if p else np.zeros_like(r)
                    duds = q * r**p * s ** max(q - 1, 0) if q else np.zeros_like(r)
                    np.testing.assert_allclose(Dr @ u, dudr, atol=1e-10)
                    np.testing.assert_allclose(Ds @ u, duds, atol=1e-10)

    def test_vandermonde_orthonormal_mass(self):
        # M = (V V^T)^{-1}; total mass = sum of M = triangle area = 2
        r, s = triangle_nodes(4)
        V = vandermonde_2d(4, r, s)
        M = np.linalg.inv(V @ V.T)
        np.testing.assert_allclose(M.sum(), 2.0, rtol=1e-12)


class TestTriangleContext:
    def test_box_context_geometry(self):
        mesh = box_triangles(4, 4)
        ctx = build_triangle_context(2, mesh)
        J = np.asarray(ctx.J)
        assert np.all(J > 0)
        # total area of [-1,1]^2 = sum over elements of integral of 1:
        # area = sum_k J_k * (ref area 2) / ... easier: M J summed
        V = np.asarray(ctx.V)
        M = np.linalg.inv(V @ V.T)
        area = float(np.sum(M.sum(axis=0)[None, :] * J))
        np.testing.assert_allclose(area, 4.0, rtol=1e-12)

    def test_maps_coordinates_match(self):
        mesh = box_triangles(3, 5)
        ctx = build_triangle_context(3, mesh)
        x = np.asarray(ctx.x).reshape(-1)
        y = np.asarray(ctx.y).reshape(-1)
        vm = np.asarray(ctx.vmapM).reshape(-1)
        vp = np.asarray(ctx.vmapP).reshape(-1)
        np.testing.assert_allclose(x[vm], x[vp], atol=1e-12)
        np.testing.assert_allclose(y[vm], y[vp], atol=1e-12)

    def test_mapP_consistent_with_vmapP(self):
        mesh = box_triangles(3, 3)
        ctx = build_triangle_context(4, mesh)
        vm = np.asarray(ctx.vmapM).reshape(-1)
        vp = np.asarray(ctx.vmapP).reshape(-1)
        mp = np.asarray(ctx.mapP).reshape(-1)
        # gathering vmapM through mapP must reproduce vmapP
        np.testing.assert_array_equal(vm[mp], vp)

    def test_normals_unit_and_outward(self):
        mesh = box_triangles(2, 2)
        ctx = build_triangle_context(3, mesh)
        nx = np.asarray(ctx.nx)
        ny = np.asarray(ctx.ny)
        np.testing.assert_allclose(nx**2 + ny**2, 1.0, atol=1e-12)
        # outward: dot of normal with (face node - element centroid) > 0
        x, y = np.asarray(ctx.x), np.asarray(ctx.y)
        fm = np.asarray(ctx.fmask).reshape(-1)
        cx, cy = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
        dot = nx * (x[:, fm] - cx) + ny * (y[:, fm] - cy)
        assert np.all(dot > 0)

    def test_grad_of_linear_field(self):
        mesh = box_triangles(3, 3)
        ctx = build_triangle_context(4, mesh)
        import jax.numpy as jnp

        u = 2.0 * ctx.x + 3.0 * ctx.y
        ux, uy = ctx.grad(u)
        np.testing.assert_allclose(np.asarray(ux), 2.0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(uy), 3.0, atol=1e-10)

    def test_boundary_nodes_on_box_edge(self):
        mesh = box_triangles(3, 3)
        ctx = build_triangle_context(2, mesh)
        x = np.asarray(ctx.x).reshape(-1)
        y = np.asarray(ctx.y).reshape(-1)
        vb = np.asarray(ctx.vmapB)[np.asarray(ctx.maskB)]
        on_edge = (
            (np.abs(np.abs(x[vb]) - 1.0) < 1e-12) | (np.abs(np.abs(y[vb]) - 1.0) < 1e-12)
        )
        assert np.all(on_edge)


@pytest.mark.skipif(
    not __import__("os").path.isdir(REF_MESHES), reason="reference meshes unavailable"
)
class TestReferenceMeshes:
    def test_read_coarse_box(self):
        mesh = read_gmsh(f"{REF_MESHES}/coarse_box.msh")
        assert mesh.num_elements == 40
        assert mesh.num_faces == 3
        ctx = build_triangle_context(1, mesh)
        assert np.all(np.asarray(ctx.J) > 0)

    def test_read_box(self):
        mesh = read_gmsh(f"{REF_MESHES}/box.msh")
        # poisson2d baseline notes K=1046 triangles (BASELINE.md)
        assert mesh.num_elements == 1046
        ctx = build_triangle_context(2, mesh)
        vm = np.asarray(ctx.vmapM).reshape(-1)
        vp = np.asarray(ctx.vmapP).reshape(-1)
        x = np.asarray(ctx.x).reshape(-1)
        y = np.asarray(ctx.y).reshape(-1)
        np.testing.assert_allclose(x[vm], x[vp], atol=1e-9)
        np.testing.assert_allclose(y[vm], y[vp], atol=1e-9)


def test_structured_face_trace_matches_flat_gather():
    """The face-granular '+'-trace (row gather + node-order flip) must be bitwise identical to the flat node-level mapP gather,
    including on boundary (self) faces; both triangles and quads."""
    import jax.numpy as jnp

    from blitzdg_jax.mesh import box_quads
    from blitzdg_jax.specgrid.quad import build_quad_context

    for ctx in (
        build_triangle_context(3, box_triangles(4, 5)),
        build_quad_context(2, box_quads(3, 4)),
    ):
        assert ctx.face_nbr is not None and ctx.face_flip is not None
        u = jnp.asarray(
            np.random.default_rng(0).normal(size=(ctx.k_elem, ctx.n_p))
        )
        fM, fP = ctx.surface_trace(u)
        # flat reference path
        fM_ref = jnp.take(u, ctx.fmask.reshape(-1), axis=-1).reshape(-1)
        fP_ref = jnp.take(fM_ref, ctx.mapP.reshape(-1), axis=-1)
        np.testing.assert_array_equal(np.asarray(fM).reshape(-1),
                                      np.asarray(fM_ref))
        np.testing.assert_array_equal(np.asarray(fP).reshape(-1),
                                      np.asarray(fP_ref))
        # batched input
        ub = jnp.stack([u, 2.0 * u])
        fMb, fPb = ctx.surface_trace(ub)
        np.testing.assert_array_equal(np.asarray(fPb[0]).reshape(-1),
                                      np.asarray(fP_ref))


def test_interp_matrix_2d_exact_for_polynomials():
    """Interpolation to arbitrary (r,s) is exact for polynomials of total
    degree <= N (reference analog: computeInterpMatrix,
    src/TriangleNodesProvisioner.cpp:1140-1152)."""
    from blitzdg_jax.specgrid.triangle import (
        interp_matrix_2d,
        triangle_nodes,
        vandermonde_2d,
    )

    N = 5
    r, s = triangle_nodes(N)
    V = vandermonde_2d(N, r, s)
    rng = np.random.default_rng(7)
    # random points inside the reference triangle (barycentric samples)
    lam = rng.dirichlet((1.0, 1.0, 1.0), size=40)
    verts = np.array([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]])
    pts = lam @ verts
    ro, so = pts[:, 0], pts[:, 1]
    IM = interp_matrix_2d(N, V, ro, so)
    assert IM.shape == (40, r.size)
    for p, q in [(0, 0), (3, 2), (5, 0), (2, 3), (0, 5)]:
        f_nodal = r**p * s**q
        np.testing.assert_allclose(IM @ f_nodal, ro**p * so**q, atol=1e-10)
