"""Generate compact positive-weight triangle cubature tables by node
elimination (the Xiao-Gimbutas construction idea, implemented from
scratch): start from the exact collapsed (Duffy) rule, then repeatedly
remove a point and re-solve the moment equations

    sum_i w_i phi_k(r_i, s_i) = int_T phi_k     (orthonormal Dubiner basis)

with Levenberg-Marquardt over all remaining (r_i, s_i, w_i), accepting the
elimination only when the residual stays at machine zero, all weights stay
positive, and all points stay inside the reference triangle. This does NOT
copy the reference's hardcoded table (include/TriangleCubatureRules.hpp —
which has a data-entry defect at rule 3, SURVEY.md defects); it regenerates
better rules from first principles.

Writes blitzdg_jax/specgrid/_cubature_tables.npz with r/s/w per order.
Rerun:  python tools/gen_cubature.py [max_order]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from scipy.optimize import least_squares

from blitzdg_jax.specgrid.cubature import duffy_cubature
from blitzdg_jax.specgrid.triangle import grad_vandermonde_2d, vandermonde_2d

TOL_RES = 1e-12
W_MIN = 1e-9
BARY_TOL = 1e-9


def moments(order):
    """Exact integrals of the orthonormal Dubiner basis up to `order`
    (computed with the exact Duffy rule; int phi_0 = sqrt(2), rest 0)."""
    r, s, w = duffy_cubature(2 * order)  # overkill exactness
    V = vandermonde_2d(order, r, s)
    return V.T @ w


def residual(x, order, m):
    n = x.size // 3
    r, s, w = x[:n], x[n:2 * n], x[2 * n:]
    V = vandermonde_2d(order, r, s)
    return V.T @ w - m


def jacobian(x, order, m):
    """Analytic d(residual)/d(r, s, w): columns [w_i dphi_k/dr(x_i),
    w_i dphi_k/ds(x_i), phi_k(x_i)] — avoids ~3n finite-difference
    evaluations per LM iteration (100x on the large orders)."""
    n = x.size // 3
    r, s, w = x[:n], x[n:2 * n], x[2 * n:]
    V = vandermonde_2d(order, r, s)      # (n, Nb)
    Vr, Vs = grad_vandermonde_2d(order, r, s)
    return np.concatenate([(w[:, None] * Vr).T, (w[:, None] * Vs).T, V.T],
                          axis=1)  # (Nb, 3n)


def inside(r, s, tol=BARY_TOL):
    l1 = (s + 1.0) / 2.0
    l2 = -(r + s) / 2.0
    l3 = (r + 1.0) / 2.0
    return (l1 > -tol) & (l2 > -tol) & (l3 > -tol)


def try_solve(r, s, w, order, m):
    x0 = np.concatenate([r, s, w])
    method = "lm" if m.size >= x0.size else "trf"
    sol = least_squares(residual, x0, jac=jacobian, args=(order, m),
                        method=method,
                        xtol=1e-15, ftol=1e-15, gtol=1e-15, max_nfev=400)
    n = r.size
    r2, s2, w2 = sol.x[:n], sol.x[n:2 * n], sol.x[2 * n:]
    ok = (np.max(np.abs(residual(sol.x, order, m))) < TOL_RES
          and np.all(w2 > W_MIN) and np.all(inside(r2, s2)))
    return ok, r2, s2, w2


def generate(order, verbose=True):
    m = moments(order)
    r, s, w = duffy_cubature(order)
    n0 = r.size
    improved = True
    while improved and r.size > m.size // 3 + 1:
        improved = False
        # try removing points in order of increasing weight (least important
        # first), a handful of candidates per round
        for idx in np.argsort(w)[:6]:
            keep = np.ones(r.size, dtype=bool)
            keep[idx] = False
            ok, r2, s2, w2 = try_solve(r[keep], s[keep], w[keep], order, m)
            if ok:
                r, s, w = r2, s2, w2
                improved = True
                break
    if verbose:
        print(f"order {order:2d}: {n0:3d} (Duffy) -> {r.size:3d} points, "
              f"residual {np.max(np.abs(residual(np.concatenate([r, s, w]), order, m))):.2e}")
    return r, s, w


def main(max_order=21):
    tables = {}
    for order in range(2, max_order + 1):
        r, s, w = generate(order)
        tables[f"r{order}"] = r
        tables[f"s{order}"] = s
        tables[f"w{order}"] = w
    out = os.path.join(os.path.dirname(__file__), "..",
                       "blitzdg_jax", "specgrid", "_cubature_tables.npz")
    np.savez_compressed(out, **tables)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 21)
