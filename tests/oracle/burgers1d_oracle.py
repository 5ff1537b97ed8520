"""Independent 1D viscous-Burgers LDG oracle — pure numpy, NO imports from
blitzdg_jax (shares only the from-the-book 1D nodal-DG builders of
advec1d_oracle). Scheme: the standard NUDG BurgersRHS1D LDG construction
(Hesthaven & Warburton ch. 7 / Codes1D) that the reference's computeRHS
also follows (/root/reference/src/burgers1d/main.cpp:127-228):

    q  = sqrt(nu) (rx Dr u - Lift(Fscale 0.5 nx du)),  du with exact-BC jumps
    f* = nx (0.5 du2 - sqrt(nu) dq) - 0.5 max|u| du
    Ru = -rx Dr (0.5 u^2 - sqrt(nu) q) + Lift(Fscale f*)

with the exact tanh traveling wave (Benton-Platzman Eq. 2 form)
u(x,t) = c/alpha - (c/alpha) tanh(c (x - c t) / (2 nu)) supplying the
initial condition, inflow/outflow boundary data, and the final max-norm
error (main.cpp:109-112 semantics). Reference config #2:
N=6, K=40, x in [-5,5], nu=0.1, c=0.5, CFL=0.75, T=0.1,
dt = CFL min(dx/|c|, dx^2/sqrt(nu)) (main.cpp:31-60).
"""
import numpy as np

from advec1d_oracle import RK4A, RK4B, jacobi_gl, jacobi_p, grad_jacobi_p


def exact(x, t, alpha, nu, c):
    return (c / alpha) - (c / alpha) * np.tanh(0.5 * (c / nu) * (x - c * t))


def run_reference_config(n_order=6, k_elem=40, xmin=-5.0, xmax=5.0,
                        alpha=1.0, nu=0.1, c=0.5, cfl=0.75, t_final=0.1):
    Np = n_order + 1
    r = jacobi_gl(0.0, 0.0, n_order)
    V = np.stack([jacobi_p(r, 0, 0, j) for j in range(Np)], axis=1)
    Vr = np.stack([grad_jacobi_p(r, 0, 0, j) for j in range(Np)], axis=1)
    Dr = Vr @ np.linalg.inv(V)
    E = np.zeros((Np, 2))
    E[0, 0] = 1.0
    E[-1, 1] = 1.0
    lift = V @ (V.T @ E)

    ve = np.linspace(xmin, xmax, k_elem + 1)
    x = (ve[:-1][:, None] + 0.5 * (r[None, :] + 1.0)
         * (ve[1:] - ve[:-1])[:, None])
    J = x @ Dr.T
    rx = 1.0 / J
    nx = np.tile(np.array([-1.0, 1.0]), (k_elem, 1))
    fscale = 1.0 / J[:, [0, Np - 1]]

    ids = np.arange(k_elem * Np).reshape(k_elem, Np)
    vmapM = np.stack([ids[:, 0], ids[:, -1]], axis=1)
    vmapP = vmapM.copy()
    vmapP[1:, 0] = ids[:-1, -1]
    vmapP[:-1, 1] = ids[1:, 0]
    xI, xO = x[0, 0], x[-1, -1]

    dx_min = x[0, 1] - x[0, 0]
    dt = cfl * min(dx_min / abs(c), dx_min**2 / np.sqrt(nu))
    num_steps = int(np.ceil(t_final / dt))
    sq_nu = np.sqrt(nu)

    u = exact(x, 0.0, alpha, nu, c)

    def rhs(u, t):
        uf = u.reshape(-1)
        uM = uf[vmapM.reshape(-1)]
        uP = uf[vmapP.reshape(-1)]
        uL = exact(xI, t, alpha, nu, c)
        uR = exact(xO, t, alpha, nu, c)
        maxvel = np.max(np.abs(u))

        du = uM - uP
        du[0] = 2.0 * (uf[0] - uL)          # inflow face (k=0, left)
        du[-1] = 2.0 * (uf[-1] - uR)        # outflow face (k=K-1, right)
        nxr = nx.reshape(-1)

        q = sq_nu * (rx * (u @ Dr.T)
                     - (fscale * (0.5 * nx.reshape(k_elem, 2)
                                  * du.reshape(k_elem, 2))) @ lift.T)
        qf = q.reshape(-1)
        qM = qf[vmapM.reshape(-1)]
        qP = qf[vmapP.reshape(-1)]
        dq = 0.5 * (qM - qP)
        dq[0] = 0.0
        dq[-1] = 0.0

        du2 = 0.5 * (uM * uM - uP * uP)
        du2[0] = uf[0] * uf[0] - uL * uL
        du2[-1] = uf[-1] * uf[-1] - uR * uR

        flux = nxr * (0.5 * du2 - sq_nu * dq) - 0.5 * maxvel * du
        vol = 0.5 * u * u - sq_nu * q
        return (-rx * (vol @ Dr.T)
                + (fscale * flux.reshape(k_elem, 2)) @ lift.T)

    res = np.zeros_like(u)
    t = 0.0
    for _ in range(num_steps):
        for s in range(5):
            res = RK4A[s] * res + dt * rhs(u, t + 0.0)
            u = u + RK4B[s] * res
        t += dt

    err = float(np.max(np.abs(u - exact(x, t, alpha, nu, c))))
    return x, u, err, t


if __name__ == "__main__":
    _, _, err, t = run_reference_config()
    print(f"oracle max-norm error at t={t:.6f}: {err:.15e}")
