"""Golden-value tests for the 1D spectral building blocks.

Mirrors the reference igloo golden assertions (framework-independent math):
src/test/JacobiBuildersTests.cpp:34-199, src/test/Nodes1DProvisionerTests.cpp:45-265.
"""
import numpy as np
import pytest

from blitzdg_jax.specgrid.jacobi import (
    gauss_lobatto_points,
    gauss_quadrature,
    grad_jacobi_p,
    jacobi_p,
)
from blitzdg_jax.specgrid.nodes1d import build_nodes1d
from blitzdg_jax.specgrid.vandermonde import dmatrix_1d, vandermonde_1d


class TestJacobi:
    def test_legendre_p0(self):
        x = np.array([-1.0, 0.0, 1.0])
        np.testing.assert_allclose(jacobi_p(x, 0, 0, 0), 1 / np.sqrt(2), rtol=1e-14)

    def test_legendre_p1(self):
        x = np.array([-1.0, 0.0, 1.0])
        np.testing.assert_allclose(
            jacobi_p(x, 0, 0, 1), [-np.sqrt(1.5), 0.0, np.sqrt(1.5)], atol=1e-14
        )

    def test_legendre_p2(self):
        x = np.array([-1.0, 0.0, 1.0])
        np.testing.assert_allclose(
            jacobi_p(x, 0, 0, 2),
            [np.sqrt(2.5), -np.sqrt(5.0 / 8.0), np.sqrt(2.5)],
            atol=1e-14,
        )

    def test_legendre_p1_4pt(self):
        x = np.array([-1, -0.447214, 0.447214, 1])
        np.testing.assert_allclose(
            jacobi_p(x, 0, 0, 1),
            [-1.224744871391589, -0.547722557505166, 0.547722557505166, 1.224744871391589],
            atol=1e-6,
        )

    def test_orthonormality(self):
        # int P_m P_n w(x) dx = delta_mn via a high-order Gauss rule
        for (a, b) in [(0.0, 0.0), (1.0, 1.0), (2.0, 0.5)]:
            x, w = gauss_quadrature(a, b, 20)
            for m in range(5):
                for n in range(5):
                    val = np.sum(w * jacobi_p(x, a, b, m) * jacobi_p(x, a, b, n))
                    np.testing.assert_allclose(val, float(m == n), atol=1e-12)

    def test_grad_jacobi_fd(self):
        x = np.linspace(-0.9, 0.9, 7)
        h = 1e-6
        for n in range(1, 5):
            fd = (jacobi_p(x + h, 0.3, 0.7, n) - jacobi_p(x - h, 0.3, 0.7, n)) / (2 * h)
            np.testing.assert_allclose(grad_jacobi_p(x, 0.3, 0.7, n), fd, rtol=1e-6)

    def test_gauss_lobatto_n4(self):
        # N=4 LGL points: 0, ±1, ±sqrt(3/7)
        r = gauss_lobatto_points(0, 0, 4)
        np.testing.assert_allclose(
            r, [-1, -np.sqrt(3.0 / 7.0), 0, np.sqrt(3.0 / 7.0), 1], atol=1e-14
        )

    def test_gauss_quadrature_exactness(self):
        # (n+1)-point Gauss rule integrates x^k exactly for k <= 2n+1
        x, w = gauss_quadrature(0.0, 0.0, 3)
        for k in range(8):
            exact = (1 - (-1) ** (k + 1)) / (k + 1)
            np.testing.assert_allclose(np.sum(w * x**k), exact, atol=1e-13)


class TestVandermonde1D:
    def test_golden_v_n3(self):
        r = gauss_lobatto_points(0, 0, 3)
        V = vandermonde_1d(3, r)
        expected = np.array(
            [
                [0.70711, -1.22474, 1.58114, -1.87083],
                [0.70711, -0.54772, -0.31623, 0.83666],
                [0.70711, 0.54772, -0.31623, -0.83666],
                [0.70711, 1.22474, 1.58114, 1.87083],
            ]
        )
        np.testing.assert_allclose(V, expected, atol=1e-5)

    def test_golden_dr_n3(self):
        r = gauss_lobatto_points(0, 0, 3)
        Dr = dmatrix_1d(3, r)
        expected = np.array(
            [
                [-3.0000e00, 4.0451e00, -1.5451e00, 5.0000e-01],
                [-8.0902e-01, 0.0, 1.1180e00, -3.0902e-01],
                [3.0902e-01, -1.1180e00, 0.0, 8.0902e-01],
                [-5.0000e-01, 1.5451e00, -4.0451e00, 3.0000e00],
            ]
        )
        np.testing.assert_allclose(Dr, expected, atol=1e-4)

    def test_dr_differentiates_polynomials_exactly(self):
        for N in [1, 2, 4, 7]:
            r = gauss_lobatto_points(0, 0, N)
            Dr = dmatrix_1d(N, r)
            for p in range(N + 1):
                deriv = Dr @ (r**p)
                expected = p * r ** max(p - 1, 0) if p > 0 else np.zeros_like(r)
                np.testing.assert_allclose(deriv, expected, atol=1e-10)


class TestNodes1D:
    def test_golden_xgrid(self):
        ctx = build_nodes1d(3, 5, -1.0, 1.0)
        x = np.asarray(ctx.x)  # (K, Np) element-major
        expected_cols = np.array(
            [
                [-1.000000, -0.600000, -0.200000, 0.200000, 0.600000],
                [-0.889443, -0.489443, -0.089443, 0.310557, 0.710557],
                [-0.710557, -0.310557, 0.089443, 0.489443, 0.889443],
                [-0.600000, -0.200000, 0.200000, 0.600000, 1.000000],
            ]
        )  # reference layout (Np, K); ours is the transpose
        np.testing.assert_allclose(x, expected_cols.T, atol=1e-5)

    def test_jacobian_and_fscale(self):
        ctx = build_nodes1d(3, 5, -1.0, 1.0)
        # uniform grid on [-1,1] with K=5: J = dx/dr = width/2 = 0.2
        np.testing.assert_allclose(np.asarray(ctx.J), 0.2, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(ctx.rx), 5.0, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(ctx.fscale), 5.0, rtol=1e-12)

    def test_lift_golden_shape_and_values(self):
        # 1D Lift = V V^T E: endpoint columns of M^{-1}
        ctx = build_nodes1d(3, 5, -1.0, 1.0)
        lift = np.asarray(ctx.lift)
        assert lift.shape == (4, 2)
        V = np.asarray(ctx.V)
        Minv = V @ V.T
        np.testing.assert_allclose(lift[:, 0], Minv[:, 0], rtol=1e-12)
        np.testing.assert_allclose(lift[:, 1], Minv[:, -1], rtol=1e-12)

    def test_vmaps(self):
        ctx = build_nodes1d(2, 4, 0.0, 1.0)
        vmapM = np.asarray(ctx.vmapM)
        vmapP = np.asarray(ctx.vmapP)
        Np = 3
        # interior faces point at the matching neighbor endpoint
        assert vmapP[1, 0] == 0 * Np + 2
        assert vmapP[1, 1] == 2 * Np + 0
        # boundaries are self-referential
        assert vmapP[0, 0] == vmapM[0, 0] == 0
        assert vmapP[3, 1] == vmapM[3, 1] == 4 * Np - 1
        # node coordinates actually coincide under the maps
        x = np.asarray(ctx.x).reshape(-1)
        np.testing.assert_allclose(x[vmapM.ravel()], x[vmapP.ravel()], atol=1e-12)

    def test_normals(self):
        ctx = build_nodes1d(2, 4, 0.0, 1.0)
        nx = np.asarray(ctx.nx)
        np.testing.assert_allclose(nx[:, 0], -1.0)
        np.testing.assert_allclose(nx[:, 1], 1.0)
