"""Independent 2D nodal-DG shallow-water oracle — pure numpy, NO imports
from blitzdg_jax — written directly from the standard nodal-DG triangle
construction (Hesthaven & Warburton, "Nodal Discontinuous Galerkin
Methods", ch. 6: warp-and-blend nodes, Koornwinder-Dubiner orthonormal
simplex basis, V/Vr/Vs, Dr/Ds, Lift via edge mass matrices, geometric
factors, outward normals, connectivity by shared vertex pairs, node-
matching vmapM/vmapP) plus the conservative shallow-water scheme the
reference sw2d-simple implements (strong form, per-face trace-max
Lax-Friedrichs flux, wall-reflection BC, SSP-RK2 predictor-corrector with
exponential modal filter applied to each RHS, adaptive
dt = CFL / ((N+1)^2 * 0.5 * max|Fscale*spd|)).

Purpose: the NON-CIRCULAR golden for the BASELINE.md 1e-6 sw2d parity
target (reference config: /root/reference/src/sw2d-simple/main.cpp:33-177
— box mesh, N=1, g=9.81, CFL=0.65, eta0 = exp(-10 x^2 - 10 y^2), wall
BCs everywhere, Filter(0.9N, N)).  The framework's sw2d path is asserted
against THIS implementation (tests/test_sw2d.py), not against its own
captured output.  The reference itself cannot be compiled here (blitz++
is not in the image), so this from-the-book derivation is the independent
truth source.  Everything is (Np, K) column-major as in the book's codes.
"""
import numpy as np

try:
    from .advec1d_oracle import grad_jacobi_p, jacobi_gl, jacobi_p
except ImportError:  # pytest inserts tests/oracle on sys.path (flat import)
    from advec1d_oracle import grad_jacobi_p, jacobi_gl, jacobi_p

NODETOL = 1e-7

# Published warp-and-blend alpha-optimal parameters (H&W table 6.1).
ALPHA_OPT = [0.0000, 0.0000, 1.4152, 0.1001, 0.2751, 0.9800, 1.0999,
             1.2832, 1.3648, 1.4773, 1.4959, 1.5743, 1.5770, 1.6223, 1.6258]


def vandermonde_1d(n, r):
    return np.stack([jacobi_p(r, 0.0, 0.0, j) for j in range(n + 1)], axis=1)


def warp_factor(n, rout):
    """1D warp function mapping equidistant nodes toward LGL nodes."""
    lgl = jacobi_gl(0.0, 0.0, n)
    req = np.linspace(-1.0, 1.0, n + 1)
    veq = vandermonde_1d(n, req)
    pmat = np.stack([jacobi_p(rout, 0.0, 0.0, i) for i in range(n + 1)], axis=0)
    lmat = np.linalg.solve(veq.T, pmat)
    warp = lmat.T @ (lgl - req)
    zerof = (np.abs(rout) < 1.0 - 1e-10).astype(float)
    sf = 1.0 - (zerof * rout) ** 2
    return warp / sf + warp * (zerof - 1.0)


def nodes_2d(n):
    """Alpha-optimized warp-and-blend nodes on the equilateral triangle."""
    alpha = ALPHA_OPT[n - 1] if n < 16 else 5.0 / 3.0
    np_pts = (n + 1) * (n + 2) // 2
    l1 = np.empty(np_pts)
    l3 = np.empty(np_pts)
    sk = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            l1[sk] = i / n
            l3[sk] = j / n
            sk += 1
    l2 = 1.0 - l1 - l3
    x = -l2 + l3
    y = (-l2 - l3 + 2.0 * l1) / np.sqrt(3.0)

    blend1 = 4.0 * l2 * l3
    blend2 = 4.0 * l1 * l3
    blend3 = 4.0 * l1 * l2
    warpf1 = warp_factor(n, l3 - l2)
    warpf2 = warp_factor(n, l1 - l3)
    warpf3 = warp_factor(n, l2 - l1)
    w1 = blend1 * warpf1 * (1.0 + (alpha * l1) ** 2)
    w2 = blend2 * warpf2 * (1.0 + (alpha * l2) ** 2)
    w3 = blend3 * warpf3 * (1.0 + (alpha * l3) ** 2)
    x = x + 1.0 * w1 + np.cos(2.0 * np.pi / 3.0) * w2 + np.cos(4.0 * np.pi / 3.0) * w3
    y = y + 0.0 * w1 + np.sin(2.0 * np.pi / 3.0) * w2 + np.sin(4.0 * np.pi / 3.0) * w3
    return x, y


def xy_to_rs(x, y):
    l1 = (np.sqrt(3.0) * y + 1.0) / 3.0
    l2 = (-3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    l3 = (3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    return -l2 + l3 - l1, -l2 - l3 + l1


def rs_to_ab(r, s):
    a = np.where(np.abs(1.0 - s) > 1e-14, 2.0 * (1.0 + r) / np.where(s != 1.0, 1.0 - s, 1.0) - 1.0, -1.0)
    return a, s


def simplex_2d(a, b, i, j):
    h1 = jacobi_p(a, 0.0, 0.0, i)
    h2 = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    return np.sqrt(2.0) * h1 * h2 * (1.0 - b) ** i


def grad_simplex_2d(a, b, i, j):
    fa = jacobi_p(a, 0.0, 0.0, i)
    dfa = grad_jacobi_p(a, 0.0, 0.0, i)
    gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)

    dmdr = dfa * gb
    if i > 0:
        dmdr = dmdr * (0.5 * (1.0 - b)) ** (i - 1)
    dmds = dfa * (0.5 * (1.0 + a)) * gb
    if i > 0:
        dmds = dmds * (0.5 * (1.0 - b)) ** (i - 1)
    tmp = dgb * (0.5 * (1.0 - b)) ** i
    if i > 0:
        tmp = tmp - 0.5 * i * gb * (0.5 * (1.0 - b)) ** (i - 1)
    dmds = dmds + fa * tmp
    return dmdr * 2.0 ** (i + 0.5), dmds * 2.0 ** (i + 0.5)


def vandermonde_2d(n, r, s):
    a, b = rs_to_ab(r, s)
    cols = []
    for i in range(n + 1):
        for j in range(n + 1 - i):
            cols.append(simplex_2d(a, b, i, j))
    return np.stack(cols, axis=1)


def grad_vandermonde_2d(n, r, s):
    a, b = rs_to_ab(r, s)
    vr, vs = [], []
    for i in range(n + 1):
        for j in range(n + 1 - i):
            dr, ds = grad_simplex_2d(a, b, i, j)
            vr.append(dr)
            vs.append(ds)
    return np.stack(vr, axis=1), np.stack(vs, axis=1)


def build_fmask(r, s):
    """Per-face node index lists: face0 s=-1, face1 r+s=0, face2 r=-1."""
    f0 = np.where(np.abs(s + 1.0) < NODETOL)[0]
    f1 = np.where(np.abs(r + s) < NODETOL)[0]
    f2 = np.where(np.abs(r + 1.0) < NODETOL)[0]
    return np.stack([f0, f1, f2], axis=1)  # (Nfp, 3)


def lift_2d(n, r, s, V, fmask):
    np_pts = V.shape[0]
    nfp = n + 1
    emat = np.zeros((np_pts, 3 * nfp))
    for f, coord in enumerate([r[fmask[:, 0]], r[fmask[:, 1]], s[fmask[:, 2]]]):
        v1d = vandermonde_1d(n, coord)
        mass_edge = np.linalg.inv(v1d @ v1d.T)
        emat[fmask[:, f], f * nfp:(f + 1) * nfp] += mass_edge
    return V @ (V.T @ emat)


def filter_2d(n, V, nc, s_order):
    alpha = -np.log(np.finfo(np.float64).eps)
    diag = np.ones(V.shape[0])
    sk = 0
    for i in range(n + 1):
        for j in range(n + 1 - i):
            if (i + j) >= nc:
                frac = ((i + j) - nc) / (n - nc)
                diag[sk] = np.exp(-alpha * frac ** s_order)
            sk += 1
    return (V * diag[None, :]) @ np.linalg.inv(V)


def read_gmsh_triangles(path):
    """Minimal Gmsh 2.x ASCII reader: vertices + CCW triangles."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    i = 0
    verts = []
    vid_to_idx = {}
    tris = []
    while i < len(lines):
        if lines[i] == "$Nodes":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                vid_to_idx[int(parts[0])] = len(verts)
                verts.append((float(parts[1]), float(parts[2])))
            i += 2 + n
        elif lines[i] == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype, ntags = int(parts[1]), int(parts[2])
                if etype == 2:  # triangle
                    vids = [int(v) for v in parts[3 + ntags:6 + ntags]]
                    tris.append([vid_to_idx[v] for v in vids])
            i += 2 + n
        else:
            i += 1
    verts = np.asarray(verts, dtype=float)
    etov = np.asarray(tris, dtype=int)
    # enforce CCW orientation: positive signed area, swap 2nd/3rd otherwise
    a, b, c = verts[etov[:, 0]], verts[etov[:, 1]], verts[etov[:, 2]]
    det = (a[:, 0] - c[:, 0]) * (b[:, 1] - c[:, 1]) - (b[:, 0] - c[:, 0]) * (a[:, 1] - c[:, 1])
    flip = det < 0
    etov[flip, 1], etov[flip, 2] = etov[flip, 2].copy(), etov[flip, 1].copy()
    return verts, etov


def connect_2d(etov):
    """EToE/EToF by matching sorted vertex pairs of each face."""
    K = etov.shape[0]
    fv = [(0, 1), (1, 2), (2, 0)]
    face_of = {}
    etoe = np.tile(np.arange(K)[:, None], (1, 3))
    etof = np.tile(np.arange(3)[None, :], (K, 1))
    for k in range(K):
        for f, (i, j) in enumerate(fv):
            key = tuple(sorted((etov[k, i], etov[k, j])))
            if key in face_of:
                k2, f2 = face_of.pop(key)
                etoe[k, f], etof[k, f] = k2, f2
                etoe[k2, f2], etof[k2, f2] = k, f
            else:
                face_of[key] = (k, f)
    return etoe, etof


def build_maps_2d(x, y, etoe, etof, fmask):
    """vmapM/vmapP as (3*Nfp, K) global node ids, nodes matched by
    physical distance (tolerance scaled by face edge length)."""
    np_pts, K = x.shape
    nfp = fmask.shape[0]
    node_ids = np.arange(K * np_pts).reshape(np_pts, K, order="F")
    vmapM = np.empty((3 * nfp, K), dtype=int)
    for f in range(3):
        vmapM[f * nfp:(f + 1) * nfp, :] = node_ids[fmask[:, f], :]
    vmapP = vmapM.copy()
    xf, yf = x.flatten(order="F"), y.flatten(order="F")
    for k in range(K):
        for f in range(3):
            k2, f2 = etoe[k, f], etof[k, f]
            if k2 == k and f2 == f:
                continue  # boundary: vmapP stays = vmapM
            idM = vmapM[f * nfp:(f + 1) * nfp, k]
            idP = vmapM[f2 * nfp:(f2 + 1) * nfp, k2]
            dx = xf[idM][:, None] - xf[idP][None, :]
            dy = yf[idM][:, None] - yf[idP][None, :]
            d2 = dx * dx + dy * dy
            ref2 = (xf[idM[0]] - xf[idM[-1]]) ** 2 + (yf[idM[0]] - yf[idM[-1]]) ** 2
        # for each '-' node pick the matching '+' node
            rows, cols = np.where(d2 < NODETOL * ref2)
            assert len(rows) == nfp, "face node matching failed"
            perm = np.empty(nfp, dtype=int)
            perm[rows] = cols
            vmapP[f * nfp:(f + 1) * nfp, k] = idP[perm]
    return vmapM, vmapP


class Sw2dOracle:
    """Full from-the-book discretization for one triangular mesh."""

    def __init__(self, verts, etov, n_order):
        self.n = n = n_order
        self.K = K = etov.shape[0]
        self.nfp = n + 1
        xe, ye = nodes_2d(n)
        r, s = xy_to_rs(xe, ye)
        self.r, self.s = r, s
        V = vandermonde_2d(n, r, s)
        Vr, Vs = grad_vandermonde_2d(n, r, s)
        Vinv = np.linalg.inv(V)
        self.V = V
        self.Dr = Vr @ Vinv
        self.Ds = Vs @ Vinv
        self.fmask = build_fmask(r, s)
        self.lift = lift_2d(n, r, s, V, self.fmask)

        # physical nodes by barycentric blend of the element's vertices
        va, vb, vc = etov[:, 0], etov[:, 1], etov[:, 2]
        l2 = -(r + s) / 2.0
        l3 = (r + 1.0) / 2.0
        l1 = (s + 1.0) / 2.0
        self.x = (np.outer(l2, verts[va, 0]) + np.outer(l3, verts[vb, 0])
                  + np.outer(l1, verts[vc, 0]))  # (Np, K)
        self.y = (np.outer(l2, verts[va, 1]) + np.outer(l3, verts[vb, 1])
                  + np.outer(l1, verts[vc, 1]))

        xr, xs = self.Dr @ self.x, self.Ds @ self.x
        yr, ys = self.Dr @ self.y, self.Ds @ self.y
        self.J = xr * ys - xs * yr
        self.rx, self.sx = ys / self.J, -yr / self.J
        self.ry, self.sy = -xs / self.J, xr / self.J

        # outward normals + surface Jacobian at face nodes (3*Nfp, K)
        fm = self.fmask.flatten(order="F")
        fxr, fxs = xr[fm, :], xs[fm, :]
        fyr, fys = yr[fm, :], ys[fm, :]
        nfp = self.nfp
        nx = np.empty((3 * nfp, K))
        ny = np.empty((3 * nfp, K))
        f0, f1, f2 = slice(0, nfp), slice(nfp, 2 * nfp), slice(2 * nfp, 3 * nfp)
        nx[f0], ny[f0] = fyr[f0], -fxr[f0]
        nx[f1], ny[f1] = fys[f1] - fyr[f1], -fxs[f1] + fxr[f1]
        nx[f2], ny[f2] = -fys[f2], fxs[f2]
        sJ = np.sqrt(nx * nx + ny * ny)
        self.nx, self.ny = nx / sJ, ny / sJ
        self.sJ = sJ
        self.fscale = sJ / self.J[fm, :]

        etoe, etof = connect_2d(etov)
        self.vmapM, self.vmapP = build_maps_2d(self.x, self.y, etoe, etof, self.fmask)
        self.wall = self.vmapP == self.vmapM  # all-wall boundary (sw2d-simple)


def sw2d_rhs(o, h, hu, hv, g):
    """Strong-form conservative SWE RHS, per-face trace-max LF flux,
    wall reflection on every boundary node."""
    hf, huf, hvf = (f.flatten(order="F") for f in (h, hu, hv))
    hM, hP = hf[o.vmapM], hf[o.vmapP]
    huM, huP = huf[o.vmapM], huf[o.vmapP].copy()
    hvM, hvP = hvf[o.vmapM], hvf[o.vmapP].copy()

    w = o.wall
    un2 = 2.0 * (huM[w] * o.nx[w] + hvM[w] * o.ny[w])
    huP[w] = huM[w] - un2 * o.nx[w]
    hvP[w] = hvM[w] - un2 * o.ny[w]

    def flux(hh, hhu, hhv):
        p = 0.5 * g * hh * hh
        return hhu, hhu * hhu / hh + p, hhu * hhv / hh, hhv, hhu * hhv / hh, hhv * hhv / hh + p

    F1M, F2M, F3M, G1M, G2M, G3M = flux(hM, huM, hvM)
    F1P, F2P, F3P, G1P, G2P, G3P = flux(hP, huP, hvP)
    F1, F2, F3, G1, G2, G3 = flux(h, hu, hv)

    spdM = np.sqrt((huM / hM) ** 2 + (hvM / hM) ** 2) + np.sqrt(g * hM)
    spdP = np.sqrt((huP / hP) ** 2 + (hvP / hP) ** 2) + np.sqrt(g * hP)
    spd = np.maximum(spdM, spdP)
    lam = spd.reshape(3, o.nfp, o.K).max(axis=1, keepdims=True)
    lam = np.broadcast_to(lam, (3, o.nfp, o.K)).reshape(3 * o.nfp, o.K)

    df1 = 0.5 * ((F1M - F1P) * o.nx + (G1M - G1P) * o.ny - lam * (hM - hP))
    df2 = 0.5 * ((F2M - F2P) * o.nx + (G2M - G2P) * o.ny - lam * (huM - huP))
    df3 = 0.5 * ((F3M - F3P) * o.nx + (G3M - G3P) * o.ny - lam * (hvM - hvP))

    def div(F, G):
        return (o.rx * (o.Dr @ F) + o.sx * (o.Ds @ F)
                + o.ry * (o.Dr @ G) + o.sy * (o.Ds @ G))

    rhs1 = -div(F1, G1) + o.lift @ (o.fscale * df1)
    rhs2 = -div(F2, G2) + o.lift @ (o.fscale * df2)
    rhs3 = -div(F3, G3) + o.lift @ (o.fscale * df3)
    return rhs1, rhs2, rhs3


def timestep(o, h, hu, hv, g, cfl):
    spd = np.sqrt((hu / h) ** 2 + (hv / h) ** 2) + np.sqrt(g * h)
    spdM = spd.flatten(order="F")[o.vmapM]
    fsc_max = np.max(np.abs(o.fscale) * spdM)
    return cfl / ((o.n + 1) ** 2 * 0.5 * fsc_max)


def run_config(mesh_path, n_order=1, g=9.81, cfl=0.65, num_steps=50,
               filter_cutoff=None, filter_order=None):
    """Run the sw2d-simple reference configuration for a fixed number of
    SSP-RK2 steps (adaptive dt recomputed from the state each step, modal
    filter applied to every RHS evaluation).  Returns the oracle object
    and the final (h, hu, hv, t)."""
    verts, etov = read_gmsh_triangles(mesh_path)
    o = Sw2dOracle(verts, etov, n_order)
    if filter_cutoff is None:
        filter_cutoff = 0.9 * n_order
    if filter_order is None:
        filter_order = n_order
    filt = filter_2d(n_order, o.V, filter_cutoff, filter_order)

    eta = np.exp(-10.0 * o.x ** 2 - 10.0 * o.y ** 2)
    h = 10.0 + eta
    hu = np.zeros_like(h)
    hv = np.zeros_like(h)

    t = 0.0
    for _ in range(num_steps):
        dt = timestep(o, h, hu, hv, g, cfl)
        r1, r2, r3 = sw2d_rhs(o, h, hu, hv, g)
        r1, r2, r3 = filt @ r1, filt @ r2, filt @ r3
        h1 = h + 0.5 * dt * r1
        hu1 = hu + 0.5 * dt * r2
        hv1 = hv + 0.5 * dt * r3
        r1, r2, r3 = sw2d_rhs(o, h1, hu1, hv1, g)
        r1, r2, r3 = filt @ r1, filt @ r2, filt @ r3
        h = h + dt * r1
        hu = hu + dt * r2
        hv = hv + dt * r3
        t += dt
    return o, h, hu, hv, t


if __name__ == "__main__":
    o, h, hu, hv, t = run_config("/root/reference/input/coarse_box.msh",
                                 num_steps=50)
    print("t =", t, "eta_max =", np.abs(h - 10.0).max())
