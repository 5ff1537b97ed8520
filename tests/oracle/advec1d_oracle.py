"""Independent 1D nodal-DG advection oracle — pure numpy, NO imports from
blitzdg_jax — written directly from the standard nodal-DG construction
(Hesthaven & Warburton, "Nodal Discontinuous Galerkin Methods", ch. 2-3):
orthonormal Jacobi polynomials by three-term recurrence, Gauss-Lobatto
nodes by Golub-Welsch, V / Vr / Dr, Lift = V V^T E, upwind flux, LSERK4.

Purpose: a NON-CIRCULAR golden for the reference advec1d config
(/root/reference/src/advec1d/main.cpp:38-48: N=4, K=30, x in [-1,4],
c=0.1, CFL=0.8, T=20, zero-inflow BC, alpha=0 upwind, final max-norm error
vs the exact shifted Gaussian, main.cpp:113-119). The framework's advec1d
is asserted against THIS implementation, not against its own captured
output. The reference itself cannot be compiled here (blitz++/igloo are
not in the image), so this from-the-book derivation is the independent
truth source.
"""
import numpy as np

# Carpenter–Kennedy 5-stage low-storage RK4 (the textbook table the
# reference's LSERK4.hpp:16-27 also hardcodes)
RK4A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
])
RK4B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
])


def jacobi_p(x, alpha, beta, n):
    """Orthonormal Jacobi polynomial P_n^(a,b)(x), three-term recurrence."""
    x = np.asarray(x, dtype=float)
    ab = alpha + beta
    gamma0 = (2.0 ** (ab + 1) / (ab + 1.0)
              * _gamma_ratio(alpha + 1) * _gamma_ratio(beta + 1)
              / _gamma_ratio(ab + 1))
    pl = [np.full_like(x, 1.0 / np.sqrt(gamma0))]
    if n == 0:
        return pl[0]
    gamma1 = (alpha + 1.0) * (beta + 1.0) / (ab + 3.0) * gamma0
    pl.append(((ab + 2.0) * x / 2.0 + (alpha - beta) / 2.0)
              / np.sqrt(gamma1))
    if n == 1:
        return pl[1]
    aold = (2.0 / (2.0 + ab)
            * np.sqrt((alpha + 1.0) * (beta + 1.0) / (ab + 3.0)))
    for i in range(1, n):
        h1 = 2.0 * i + ab
        anew = (2.0 / (h1 + 2.0)
                * np.sqrt((i + 1.0) * (i + 1.0 + ab) * (i + 1.0 + alpha)
                          * (i + 1.0 + beta)
                          / ((h1 + 1.0) * (h1 + 3.0))))
        bnew = -(alpha * alpha - beta * beta) / (h1 * (h1 + 2.0))
        pl.append((-aold * pl[i - 1] + (x - bnew) * pl[i]) / anew)
        aold = anew
    return pl[n]


def _gamma_ratio(z):
    from math import gamma

    return gamma(z)


def grad_jacobi_p(x, alpha, beta, n):
    if n == 0:
        return np.zeros_like(np.asarray(x, dtype=float))
    return (np.sqrt(n * (n + alpha + beta + 1.0))
            * jacobi_p(x, alpha + 1, beta + 1, n - 1))


def jacobi_gq(alpha, beta, n):
    """Gauss quadrature points of P_n^(a,b): Golub–Welsch eigenproblem."""
    if n == 0:
        return np.array([(alpha - beta) / (alpha + beta + 2.0)]), None
    h1 = 2.0 * np.arange(n + 1) + alpha + beta
    diag = -(alpha * alpha - beta * beta) / ((h1 + 2.0) * h1)
    if alpha + beta == 0:
        diag[0] = 0.0
    i = np.arange(1, n + 1)
    off = (2.0 / (h1[:-1] + 2.0)
           * np.sqrt(i * (i + alpha + beta) * (i + alpha) * (i + beta)
                     / ((h1[:-1] + 1.0) * (h1[:-1] + 3.0))))
    J = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    x, _ = np.linalg.eigh(J)
    return np.sort(x), None


def jacobi_gl(alpha, beta, n):
    """Gauss-Lobatto points on [-1,1]: endpoints + interior GQ points."""
    if n == 1:
        return np.array([-1.0, 1.0])
    xint, _ = jacobi_gq(alpha + 1, beta + 1, n - 2)
    return np.concatenate([[-1.0], xint, [1.0]])


def run_reference_config(n_order=4, k_elem=30, xmin=-1.0, xmax=4.0,
                        c=0.1, cfl=0.8, t_final=20.0):
    """Run the full advec1d reference configuration; returns (x, u, err)."""
    Np = n_order + 1
    r = jacobi_gl(0.0, 0.0, n_order)
    V = np.stack([jacobi_p(r, 0, 0, j) for j in range(Np)], axis=1)
    Vr = np.stack([grad_jacobi_p(r, 0, 0, j) for j in range(Np)], axis=1)
    Dr = Vr @ np.linalg.inv(V)
    # Lift = V V^T E, E picking the two endpoint nodes
    E = np.zeros((Np, 2))
    E[0, 0] = 1.0
    E[-1, 1] = 1.0
    lift = V @ (V.T @ E)

    # uniform element grid, x = affine blend of element endpoints
    ve = np.linspace(xmin, xmax, k_elem + 1)
    x = (ve[:-1][:, None] + 0.5 * (r[None, :] + 1.0)
         * (ve[1:] - ve[:-1])[:, None])  # (K, Np)
    J = x @ Dr.T  # dx/dr per node, element-major (K, Np)
    rx = 1.0 / J
    # face data: faces are node 0 (left, n=-1) and node Np-1 (right, n=+1)
    nx = np.tile(np.array([-1.0, 1.0]), (k_elem, 1))  # (K, 2)
    fscale = 1.0 / J[:, [0, Np - 1]]

    # vmapM / vmapP in (K, face) global node-id convention
    ids = np.arange(k_elem * Np).reshape(k_elem, Np)
    vmapM = np.stack([ids[:, 0], ids[:, -1]], axis=1)  # (K, 2)
    vmapP = vmapM.copy()
    vmapP[1:, 0] = ids[:-1, -1]   # left face neighbor = right node of k-1
    vmapP[:-1, 1] = ids[1:, 0]    # right face neighbor = left node of k+1
    # domain boundary: vmapP == vmapM at inflow (k=0,f=0), outflow (k=K-1,f=1)

    dx_min = x[0, 1] - x[0, 0]
    dt = cfl * dx_min / abs(c)
    num_steps = int(np.ceil(t_final / dt))

    u = np.exp(-10.0 * x * x)

    def rhs(u):
        uf = u.reshape(-1)
        uM = uf[vmapM.reshape(-1)]
        uP = uf[vmapP.reshape(-1)].copy()
        # BCs: zero inflow at the left domain face, outflow uP=uM (already
        # true since vmapP==vmapM there)
        uP[0] = 0.0
        # upwind (alpha=0): du = (uM-uP) (c nx - |c nx|)/2
        cn = c * nx.reshape(-1)
        du = (uM - uP) * (cn - np.abs(cn)) / 2.0
        return (-c * rx * (u @ Dr.T)
                + (fscale * du.reshape(k_elem, 2)) @ lift.T)

    res = np.zeros_like(u)
    for _ in range(num_steps):
        for s in range(5):
            res = RK4A[s] * res + dt * rhs(u)
            u = u + RK4B[s] * res

    t_end = num_steps * dt
    exact = np.exp(-10.0 * (x - c * t_end) ** 2)
    err = float(np.max(np.abs(u - exact)))
    return x, u, err


if __name__ == "__main__":
    _, _, err = run_reference_config()
    print(f"oracle max-norm error: {err:.15e}")
