"""Matrix-free interior-penalty Poisson/Laplacian operators (1D and 2D).

Device-resident operators for Krylov solves. Functional parity targets:
 - 1D SIP operator (src/poisson1d/Poisson1d.hpp:24-137): tau = Np^2/hmin,
   symmetrized by J*M (left mass-matrix multiply);
 - 2D LDG/IP operator (src/poisson2d/Poisson2d.hpp:24-167): central gradient
   flux with Dirichlet (uP=-uM) on Wall/Dirichlet tags, Neumann gradient
   mirror, penalty tau = Np/hmin.

The symmetric variants multiply by J*M so CG applies; they are the
discretization of  -(grad u, grad v) + surface terms  in weak form.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import dg_op
from ..context import BC_DIRICHLET, BC_NEUMAN, BC_WALL, DGContext1D, DGContext2D


def _trace(ctx, f):
    return ctx.surface_trace(f)


@dg_op
def poisson2d_op(
    ctx: DGContext2D,
    u: jnp.ndarray,
    tau: float | None = None,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
    symmetrize: bool = False,
) -> jnp.ndarray:
    """Apply the 2D IP Laplacian to u: (K, Np) -> (K, Np).

    With ``symmetrize`` the output is J*M*(L u) making the operator
    symmetric negative-definite (use with CG on -A).
    """
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    n_p = ctx.n_p

    if tau is None:
        # Standard SIP penalty tau ~ (N+1)^2 / h. NOTE: deliberately NOT the
        # reference's tau = Np*max(J)/2 (Poisson2d.hpp:143-144), which is far
        # below the coercivity threshold — their GMRES run only converged
        # because it warm-starts from the exact solution (main.cpp:90).
        # Verified: this choice makes the symmetrized operator negative
        # definite (eigenvalue check in tests).
        tau = (ctx.n_order + 1) ** 2 * jnp.max(ctx.fscale)

    ux, uy = ctx.grad(u)

    uM, uP = _trace(ctx, u)
    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Dirichlet: uP = -uM (zero trace); Neumann handled on the gradient.
    for tag in dirichlet_tags:
        idx, mask = ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag]
        uP = uP.at[idx].set(jnp.where(mask, -uM[idx], uP[idx]))

    du = uM - uP
    du_mat = du.reshape(K, n_tr)

    # Auxiliary gradient with central flux: q = grad u - Lift(n du / 2)
    qx = ux - ((ctx.fscale * ctx.nx * du_mat * 0.5) @ ctx.lift.T)
    qy = uy - ((ctx.fscale * ctx.ny * du_mat * 0.5) @ ctx.lift.T)

    uxM, uxP = _trace(ctx, ux)
    uyM, uyP = _trace(ctx, uy)
    qxM, _ = _trace(ctx, qx)
    qyM, _ = _trace(ctx, qy)

    # Neumann: mirror the gradient so the normal component cancels.
    for tag in neumann_tags:
        idx, mask = ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag]
        un = uxM[idx] * nxf[idx] + uyM[idx] * nyf[idx]
        uxP = uxP.at[idx].set(jnp.where(mask, uxM[idx] - 2.0 * nxf[idx] * un, uxP[idx]))
        uyP = uyP.at[idx].set(jnp.where(mask, uyM[idx] - 2.0 * nyf[idx] * un, uyP[idx]))

    # interior-penalty numerical flux for the divergence stage:
    # q* = average of the one-sided gradients
    dqx = qxM - 0.5 * (uxM + uxP)
    dqy = qyM - 0.5 * (uyM + uyP)

    # No 1/2 on the final surface term: with q* = {grad u} the half is
    # already inside the averages; the extra /2.0 the reference applies
    # (Poisson2d.hpp:149) breaks symmetry (checked numerically).
    surf = (
        ctx.nx * dqx.reshape(K, n_tr)
        + ctx.ny * dqy.reshape(K, n_tr)
        + tau * du_mat
    )

    qxr, qxs = qx @ ctx.Dr.T, qx @ ctx.Ds.T
    qyr, qys = qy @ ctx.Dr.T, qy @ ctx.Ds.T
    lap = (
        ctx.rx * qxr + ctx.sx * qxs + ctx.ry * qyr + ctx.sy * qys
        - (ctx.fscale * surf) @ ctx.lift.T
    )

    if symmetrize:
        M = ctx.Vinv.T @ ctx.Vinv
        lap = ctx.J * (lap @ M.T)
    return lap


@dg_op
def poisson1d_op(
    ctx: DGContext1D,
    u: jnp.ndarray,
    tau: float | None = None,
    symmetrize: bool = True,
) -> jnp.ndarray:
    """1D SIP Laplacian (Dirichlet u=0 ends), u: (K, Np) -> (K, Np).
    Reference analog: Poisson1d.hpp:24-137."""
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    n_p = ctx.n_p

    if tau is None:
        tau = n_p * n_p * jnp.max(1.0 / ctx.J) / 2.0  # Np^2/hmin

    ux = ctx.rx * (u @ ctx.Dr.T)

    uM, uP = _trace(ctx, u)
    nxf = ctx.nx.reshape(-1)
    # Dirichlet at both domain ends: uP = -uM
    uP = uP.at[ctx.mapI].set(-uM[ctx.mapI])
    uP = uP.at[ctx.mapO].set(-uM[ctx.mapO])
    du = (uM - uP).reshape(K, n_tr)

    q = ux - ((ctx.fscale * ctx.nx * du * 0.5) @ ctx.lift.T)

    qM, qP = _trace(ctx, q)
    uxM, uxP = _trace(ctx, ux)
    # Neumann mirror not needed (pure Dirichlet problem); IP flux:
    dq = (qM - 0.5 * (uxM + uxP)).reshape(K, n_tr)

    # reference form (Poisson1d.hpp:122-127): nx*(dq + tau*nx*du),
    # no extra half (nx^2 = 1 in 1D)
    surf = ctx.nx * dq + tau * du
    lap = ctx.rx * (q @ ctx.Dr.T) - (ctx.fscale * surf) @ ctx.lift.T

    if symmetrize:
        M = ctx.Vinv.T @ ctx.Vinv
        lap = ctx.J * (lap @ M.T)
    return lap


@dg_op
def apply_mass(ctx, f: jnp.ndarray) -> jnp.ndarray:
    """J * (M f) — the weak-form load-vector weighting."""
    M = ctx.Vinv.T @ ctx.Vinv
    return ctx.J * (f @ M.T)


@dg_op
def apply_mass_curved(cub, f: jnp.ndarray) -> jnp.ndarray:
    """Curved weak load: (f, v) via cubature, exact for curved Jacobians
    (reference analog: the per-element custom mass matrices MM_k = V^T W J V,
    src/TriangleNodesProvisioner.cpp:160-182)."""
    fc = f @ cub.V.T
    return (cub.W * fc) @ cub.V


@dg_op
def poisson2d_curved_op(
    ctx: DGContext2D,
    cub,
    gauss,
    u: jnp.ndarray,
    tau: float | None = None,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> jnp.ndarray:
    """Curved/over-integrated matrix-free Poisson operator: weak-form LDG
    Laplacian evaluated with cubature volume integrals and Gauss-node
    surface integrals.

    This is the matrix-free equivalent of the reference's curved
    Poisson2DSparseMatrix variant (src/Poisson2DSparseMatrix.cpp:37-317,
    cubature/Gauss assembly): instead of assembling a sparse operator on
    host, the same weak form is applied matrix-free on device so it can be
    fed to CG — per the SURVEY §7.1 stance (on-device operators stay
    matrix-free; assembly remains a host-side oracle). Central gradient
    flux + penalty, Dirichlet via uP=-uM, Neumann via gradient mirror
    (the BC conventions of src/poisson2d/Poisson2d.hpp:70-129).

    Returns the M-WEIGHTED residual (M A u), symmetric positive
    semi-definite, so pair it with ``apply_mass_curved`` on the RHS and
    solve with CG. Fields are (K, Np).
    """
    K = ctx.k_elem
    NG = gauss.n_gauss
    n_g = 3 * NG

    if tau is None:
        tau = (ctx.n_order + 1) ** 2 * jnp.max(ctx.fscale)

    # --- traces of u at Gauss nodes, with BC substitution ---
    at_g = lambda f: (f @ gauss.interp.T).reshape(-1)
    gu = at_g(u)
    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    uM, uP = gu[mM], gu[mP]
    for tag in dirichlet_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        uP = uP.at[idx].set(jnp.where(mask, -uM[idx], uP[idx]))
    ustar = 0.5 * (uM + uP)
    du = (uM - uP).reshape(K, n_g)

    nxf = gauss.nx.reshape(-1)
    nyf = gauss.ny.reshape(-1)

    # --- pass 1: weak gradient q = grad u ---
    # (q, v) = -(u, grad v) + surface(u* n v); per-element mass inverted.
    uc = u @ cub.V.T  # (K, Ncub)

    def weak(tx, ty):
        return (cub.W * tx) @ cub.Dr + (cub.W * ty) @ cub.Ds  # Dr^T from right

    sx_u = (gauss.W * (ustar * nxf).reshape(K, n_g)) @ gauss.interp
    sy_u = (gauss.W * (ustar * nyf).reshape(K, n_g)) @ gauss.interp
    MMqx = -weak(cub.rx * uc, cub.sx * uc) + sx_u
    MMqy = -weak(cub.ry * uc, cub.sy * uc) + sy_u
    inv = lambda mm: jnp.einsum("kij,kj->ki", cub.MMinv, mm)
    qx, qy = inv(MMqx), inv(MMqy)

    # --- traces of q, Neumann gradient mirror ---
    gqx, gqy = at_g(qx), at_g(qy)
    qxM, qxP = gqx[mM], gqx[mP]
    qyM, qyP = gqy[mM], gqy[mP]
    for tag in neumann_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        qn = qxM[idx] * nxf[idx] + qyM[idx] * nyf[idx]
        qxP = qxP.at[idx].set(jnp.where(mask, qxM[idx] - 2.0 * nxf[idx] * qn, qxP[idx]))
        qyP = qyP.at[idx].set(jnp.where(mask, qyM[idx] - 2.0 * nyf[idx] * qn, qyP[idx]))

    qnstar = (
        0.5 * ((qxM + qxP) * nxf + (qyM + qyP) * nyf)
    ).reshape(K, n_g) - tau * du

    # --- pass 2: weak divergence  (M A u) = (q, grad v) - surface(qn* v) ---
    qxc, qyc = qx @ cub.V.T, qy @ cub.V.T
    vol = weak(cub.rx * qxc + cub.ry * qyc, cub.sx * qxc + cub.sy * qyc)
    return vol - (gauss.W * qnstar) @ gauss.interp


@dg_op
def poisson2d_curved_sip_op(
    ctx: DGContext2D,
    cub,
    gauss,
    u: jnp.ndarray,
    tau_scale: float = 1.0,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> jnp.ndarray:
    """Curved SIP (symmetric interior penalty, PRIMAL form) Poisson
    operator, matrix-free: cubature volume integrals (grad u, grad v) plus
    Gauss-node face terms

        + int_f [ tau (uM-uP)/2 - (DnM u + DnP u)/2 ] v
        - int_f (uM-uP)/2 Dn v

    with tau = tau_scale * 100^2 * 2 (N+1)^2 * max(hinvM, hinvP) — the
    EXACT bilinear form `assemble_poisson2d_curved` assembles on host
    (reference analog: the cubature/Gauss Poisson2DSparseMatrix variant,
    src/Poisson2DSparseMatrix.cpp:37-317 — with its as-shipped defects
    fixed, see the assembler's docstring). One pass (no auxiliary LDG
    variable), so it is also the cheaper device operator for curved
    elliptic solves. Dirichlet faces: uP=-uM, DnP=DnM; Neumann faces:
    natural (zero jump, zero mean normal-derivative).

    Returns the M-weighted SPD residual (M A u); pair with
    `apply_mass_curved` on the RHS and solve with CG. Fields are (K, Np).
    """
    K = ctx.k_elem
    NG = gauss.n_gauss
    n_g = 3 * NG
    assert gauss.Dr is not None, "gauss context lacks derivative factors; rebuild"

    # volume: (grad u, grad v) over cubature
    ur, us = u @ cub.Dr.T, u @ cub.Ds.T  # (K, Ncub)
    ux = cub.rx * ur + cub.sx * us
    uy = cub.ry * ur + cub.sy * us
    vol = ((cub.W * (ux * cub.rx + uy * cub.ry)) @ cub.Dr
           + (cub.W * (ux * cub.sx + uy * cub.sy)) @ cub.Ds)

    # traces + one-sided normal derivatives at face Gauss nodes
    gu = (u @ gauss.interp.T).reshape(-1)
    gur, gus = u @ gauss.Dr.T, u @ gauss.Ds.T  # (K, 3NG)
    gux = gauss.rx * gur + gauss.sx * gus
    guy = gauss.ry * gur + gauss.sy * gus
    dn = (gauss.nx * gux + gauss.ny * guy).reshape(-1)  # own outward normal

    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    uM, uP = gu[mM], gu[mP]
    dnM = dn[mM]
    dnP = -dn[mP]  # neighbor derivative w.r.t. the '-' normal (n_P = -n_M)

    for tag in dirichlet_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        uP = uP.at[idx].set(jnp.where(mask, -uM[idx], uP[idx]))
        dnP = dnP.at[idx].set(jnp.where(mask, dnM[idx], dnP[idx]))
    # Neumann faces keep the defaults (uP=uM, dnP=-dnM): zero jump and
    # zero mean normal derivative — the natural BC, same as the assembler
    # skipping the face entirely.

    # penalty from nodal Fscale's first face node, two-sided max
    hinv_face = ctx.fscale.reshape(K, 3, ctx.n_fp)[:, :, 0]  # (K, 3)
    hM = jnp.repeat(hinv_face, NG, axis=1).reshape(-1)
    hP = hinv_face.reshape(-1)[mP // NG]
    gtau = (tau_scale * 100.0**2 * 2.0 * (ctx.n_order + 1) ** 2
            * jnp.maximum(hM, hP))

    jump = uM - uP
    s1 = (0.5 * gtau * jump - 0.5 * (dnM + dnP)).reshape(K, n_g)
    out = vol + (gauss.W * s1) @ gauss.interp

    # symmetry term: -(1/2) Dn v-weighted jump, lifted through gDn^T
    z = gauss.W * (0.5 * jump).reshape(K, n_g)
    zx, zy = z * gauss.nx, z * gauss.ny
    out = out - ((zx * gauss.rx + zy * gauss.ry) @ gauss.Dr
                 + (zx * gauss.sx + zy * gauss.sy) @ gauss.Ds)
    return out


# ---------------------------------------------------------------------------
# Host-side assembled SIP operator (verification oracle + direct-solve path)
# ---------------------------------------------------------------------------

def assemble_poisson2d(ctx: DGContext2D, bordered: bool = False):
    """Assemble the global sparse SIP Poisson operator and mass matrix on
    host (scipy), mirroring the reference Poisson2DSparseMatrix nodal path
    (src/Poisson2DSparseMatrix.cpp:590-848): volume term
    J (Dx^T M Dx + Dy^T M Dy), SIP face terms with penalty
    gtau = 100^2 * 2 (N+1)^2 / hmin per face, Dirichlet on Wall tags.

    Returns (OP, MM) as scipy CSR matrices over the (K*Np,) flat numbering.
    ``bordered`` appends the row/column of ones for pure-Neumann
    solvability (reference :837-843).
    """
    import scipy.sparse as sp

    K, n_p, n_fp, n_faces = ctx.k_elem, ctx.n_p, ctx.n_fp, ctx.n_faces
    Dr = np.asarray(ctx.Dr)
    Ds = np.asarray(ctx.Ds)
    V = np.asarray(ctx.V)
    M = np.linalg.inv(V @ V.T)
    fmask = np.asarray(ctx.fmask)  # (3, Nfp)
    rx, ry = np.asarray(ctx.rx), np.asarray(ctx.ry)
    sx, sy = np.asarray(ctx.sx), np.asarray(ctx.sy)
    J = np.asarray(ctx.J)
    sJ = np.asarray(ctx.sJ).reshape(K, n_faces, n_fp)
    nx = np.asarray(ctx.nx).reshape(K, n_faces, n_fp)
    ny = np.asarray(ctx.ny).reshape(K, n_faces, n_fp)
    fscale = np.asarray(ctx.fscale).reshape(K, n_faces, n_fp)
    vmapM = np.asarray(ctx.vmapM).reshape(K, n_faces, n_fp)
    vmapP = np.asarray(ctx.vmapP).reshape(K, n_faces, n_fp)

    # 1D edge mass matrices on each face's nodes. Element-shape generic
    # like the reference operator (consumed on quads by ins2d,
    # src/ins2d/main.cpp:169-188): the face coordinate is the one that
    # varies along each face — (r, r, s) on triangles, (r, s, r, s) on
    # quads (f0: s=-1, f1: r=+1, f2: s=+1, f3: r=-1).
    r = np.asarray(ctx.r)
    s = np.asarray(ctx.s)
    from ..specgrid.vandermonde import vandermonde_1d

    face_coord = (r, r, s) if n_faces == 3 else (r, s, r, s)
    mass_edge = []
    for f in range(n_faces):
        fr = face_coord[f][fmask[f]]
        v1d = vandermonde_1d(ctx.n_order, fr)
        mass_edge.append(np.linalg.inv(v1d @ v1d.T))

    rows, cols, vals = [], [], []
    mrows, mcols, mvals = [], [], []

    bc_table = np.asarray(ctx.bc_table) if ctx.bc_table is not None else None

    # neighbor face table for the symmetric penalty scale (below)
    face_nbr = (np.asarray(ctx.face_nbr).reshape(K, n_faces)
                if ctx.face_nbr is not None else None)

    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds  # affine elements: constant metric
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        OP11 = J[k, 0] * (Dx.T @ M @ Dx + Dy.T @ M @ Dy)

        gids = k * n_p + np.arange(n_p)
        for f in range(n_faces):
            fm = fmask[f]
            ndotdx = nx[k, f, 0] * Dx[fm, :] + ny[k, f, 0] * Dy[fm, :]
            fsJ = sJ[k, f, 0]
            mass_f = mass_edge[f] * fsJ

            # hinv must be SYMMETRIC across the face (max of the two sides,
            # reference :754) or the penalty blocks OP12/OP21 of unequal
            # neighbors break the operator's symmetry on unstructured meshes.
            hinv = fscale[k, f, 0]
            if face_nbr is not None:
                nbr = face_nbr[k, f]
                k2n, f2n = nbr // n_faces, nbr % n_faces
                hinv = max(hinv, fscale[k2n, f2n, 0])
            gtau = 100.0**2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv

            is_boundary = np.all(vmapP[k, f, :] == vmapM[k, f, :])
            if is_boundary:
                if bc_table is not None and bc_table[k, f] == BC_NEUMAN:
                    # natural BC: no face terms in the operator; the flux
                    # data enters through assemble_bc_rhs only
                    continue
                # Dirichlet face (reference treats Wall as homogeneous
                # Dirichlet): consistency terms at full weight.
                OP11[np.ix_(fm, fm)] += gtau * mass_f
                OP11[fm, :] -= mass_f @ ndotdx
                OP11[:, fm] -= ndotdx.T @ mass_f
            else:
                k2 = vmapP[k, f, 0] // n_p
                # neighbor face id: find which face of k2 matches
                fm2_nodes = vmapP[k, f, :] - k2 * n_p
                Dx2 = rx[k2, 0] * Dr + sx[k2, 0] * Ds
                Dy2 = ry[k2, 0] * Dr + sy[k2, 0] * Ds
                ndotdx2 = nx[k, f, 0] * Dx2[fm2_nodes, :] + ny[k, f, 0] * Dy2[fm2_nodes, :]

                OP11[np.ix_(fm, fm)] += gtau * mass_f
                OP11[fm, :] -= 0.5 * (mass_f @ ndotdx)
                OP11[:, fm] -= 0.5 * (ndotdx.T @ mass_f)

                # coupling block: penalty -gtau [u][v], consistency
                # -1/2 (n.grad u+) v-, symmetry +1/2 (n.grad v-) u+
                OP12 = np.zeros((n_p, n_p))
                OP12[np.ix_(fm, fm2_nodes)] = -gtau * mass_f
                OP12[fm, :] -= 0.5 * (mass_f @ ndotdx2)
                OP12[:, fm2_nodes] += 0.5 * (ndotdx.T @ mass_f)

                gids2 = k2 * n_p + np.arange(n_p)
                rows.append(np.repeat(gids, n_p))
                cols.append(np.tile(gids2, n_p))
                vals.append(OP12.reshape(-1))

        rows.append(np.repeat(gids, n_p))
        cols.append(np.tile(gids, n_p))
        vals.append(OP11.reshape(-1))

        MMk = J[k, 0] * M
        mrows.append(np.repeat(gids, n_p))
        mcols.append(np.tile(gids, n_p))
        mvals.append(MMk.reshape(-1))

    n = K * n_p
    shape = (n + 1, n + 1) if bordered else (n, n)
    if bordered:
        ones = np.arange(n)
        rows.append(np.full(n, n))
        cols.append(ones)
        vals.append(np.ones(n))
        rows.append(ones)
        cols.append(np.full(n, n))
        vals.append(np.ones(n))
    OP = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=shape,
    )
    MM = sp.csr_matrix(
        (np.concatenate(mvals), (np.concatenate(mrows), np.concatenate(mcols))),
        shape=(n, n),
    )
    return OP, MM


def assemble_poisson2d_curved(
    ctx: DGContext2D,
    cub,
    gauss,
    tau_scale: float = 1.0,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
    bordered: bool = False,
):
    """Assemble the CURVED (cubature/Gauss) SIP Poisson operator and the
    per-element cubature mass matrix on host (scipy) — the independent
    oracle for `poisson2d_curved_sip_op` (VERDICT r3 missing #1).

    Reference analog: the curved Poisson2DSparseMatrix path
    (/root/reference/src/Poisson2DSparseMatrix.cpp:37-317): per element,
    volume term cDx^T diag(W) cDx + cDy^T diag(W) cDy with cubature
    geometric factors; per face, Gauss-node SIP terms with penalty
    gtau = 100^2 * 2 (N+1)^2 * max(hinvM, hinvP) and OP12 neighbor
    coupling using the '+' trace interpolation row ordering.

    As-shipped reference defects NOT replicated (that code never compiled
    — solver builds are disabled in the reference CMake):
     - neighbor Jacobian J2 computed from element-1 factors
       (Poisson2DSparseMatrix.cpp:206: ``J2 = -xs1*yr1 + xr1*ys1``);
       here element 2's own geometry is used;
     - the Dirichlet symmetry term assembling gVM^T W gVM instead of
       gVM^T W gDnM (:117-119 of the switch block); here the standard
       SIP Dirichlet triple (gtau M_f - C_f - C_f^T) is assembled;
     - OP12's penalty term missing the reduction index (``blitz::sum``
       over the whole expression, :130); here a proper (Np, Np) block.

    Returns (OP, MM) scipy CSR over the (K*Np,) flat element-major
    numbering. ``bordered`` appends the row/column of ones for
    pure-Neumann solvability (reference :837-843).
    """
    import scipy.sparse as sp

    K, n_p, n_faces = ctx.k_elem, ctx.n_p, ctx.n_faces
    NG = gauss.n_gauss
    assert gauss.Dr is not None, "gauss context lacks derivative factors; rebuild"

    cDr, cDs = np.asarray(cub.Dr), np.asarray(cub.Ds)  # (Ncub, Np)
    cW = np.asarray(cub.W)  # (K, Ncub)
    crx, cry = np.asarray(cub.rx), np.asarray(cub.ry)
    csx, csy = np.asarray(cub.sx), np.asarray(cub.sy)
    MMk = np.asarray(cub.MM)  # (K, Np, Np)

    ginterp = np.asarray(gauss.interp)  # (3NG, Np)
    gDr, gDs = np.asarray(gauss.Dr), np.asarray(gauss.Ds)
    grx, gry = np.asarray(gauss.rx), np.asarray(gauss.ry)
    gsx, gsy = np.asarray(gauss.sx), np.asarray(gauss.sy)
    gW = np.asarray(gauss.W).reshape(K, n_faces, NG)
    gnx = np.asarray(gauss.nx).reshape(K, n_faces, NG)
    gny = np.asarray(gauss.ny).reshape(K, n_faces, NG)
    mapM = np.asarray(gauss.mapM).reshape(K, n_faces, NG)
    mapP = np.asarray(gauss.mapP).reshape(K, n_faces, NG)
    fscale = np.asarray(ctx.fscale).reshape(K, n_faces, ctx.n_fp)
    bc_table = np.asarray(ctx.bc_table)

    # per-element cartesian derivative matrices at the face Gauss nodes
    # gDx[k] = diag(rx_g) gDr + diag(sx_g) gDs, (3NG, Np)
    gDx = grx[:, :, None] * gDr[None] + gsx[:, :, None] * gDs[None]
    gDy = gry[:, :, None] * gDr[None] + gsy[:, :, None] * gDs[None]

    rows, cols, vals = [], [], []
    mrows, mcols, mvals = [], [], []
    blk = np.arange(n_p)

    def insert(kr, kc, block):
        r = (kr * n_p + blk)[:, None] + 0 * blk[None, :]
        c = (kc * n_p + blk)[None, :] + 0 * r[:, :1]
        rows.append(np.broadcast_to(r, (n_p, n_p)).ravel())
        cols.append(np.broadcast_to(c, (n_p, n_p)).ravel())
        vals.append(np.asarray(block).ravel())

    for k in range(K):
        cDx = crx[k][:, None] * cDr + csx[k][:, None] * cDs
        cDy = cry[k][:, None] * cDr + csy[k][:, None] * cDs
        OP11 = cDx.T @ (cW[k][:, None] * cDx) + cDy.T @ (cW[k][:, None] * cDy)

        for f in range(n_faces):
            iM = slice(f * NG, (f + 1) * NG)
            jP = mapP[k, f]  # flat '+' ids into (K*3NG,)
            boundary = bool(np.all(jP == mapM[k, f]))
            w = gW[k, f]
            gVM = ginterp[iM]
            gDnM = gnx[k, f][:, None] * gDx[k][iM] + gny[k, f][:, None] * gDy[k][iM]
            WgVM = w[:, None] * gVM

            if boundary:
                tag = bc_table[k, f]
                if tag in dirichlet_tags:
                    hinv = fscale[k, f, 0]
                    gtau = tau_scale * 100.0**2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv
                    OP11 += (gtau * (gVM.T @ WgVM)
                             - gVM.T @ (w[:, None] * gDnM) - gDnM.T @ WgVM)
                # Neumann/other: natural BC, no face terms
                continue

            k2 = int(jP[0] // (3 * NG))
            j2 = jP % (3 * NG)
            f2 = int(j2[0] // NG)
            gVP = ginterp[j2]  # '+' interp rows in matched (reversed) order
            gDnP = (gnx[k, f][:, None] * gDx[k2][j2]
                    + gny[k, f][:, None] * gDy[k2][j2])
            WgVP = w[:, None] * gVP
            hinv = max(fscale[k, f, 0], fscale[k2, f2, 0])
            gtau = tau_scale * 100.0**2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv

            OP11 += 0.5 * (gtau * (gVM.T @ WgVM)
                           - gVM.T @ (w[:, None] * gDnM) - gDnM.T @ WgVM)
            OP12 = (-0.5 * gtau * (gVM.T @ WgVP)
                    - 0.5 * gVM.T @ (w[:, None] * gDnP)
                    + 0.5 * gDnM.T @ WgVP)
            insert(k, k2, OP12)

        insert(k, k, OP11)
        r = (k * n_p + blk)[:, None] + 0 * blk[None, :]
        mrows.append(np.broadcast_to(r, (n_p, n_p)).ravel())
        mcols.append(np.broadcast_to(r.T, (n_p, n_p)).ravel())
        mvals.append(MMk[k].ravel())

    n = K * n_p
    OP = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    MM = sp.coo_matrix(
        (np.concatenate(mvals), (np.concatenate(mrows), np.concatenate(mcols))),
        shape=(n, n)).tocsr()
    if bordered:
        ones = np.ones((n, 1))
        OP = sp.bmat([[OP, ones], [ones.T, None]], format="csr")
    return OP, MM


def assemble_bc_rhs(
    ctx: DGContext2D,
    ubc: np.ndarray,
    qbc: np.ndarray,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> np.ndarray:
    """Boundary-data load vector for the assembled SIP operator.

    Reference analog: Poisson2DSparseMatrix::buildBcRhs
    (src/Poisson2DSparseMatrix.cpp:319-487). With prescribed Dirichlet trace
    ``ubc`` and Neumann flux ``qbc`` (both (K, Nfaces*Nfp)), returns b with

        OP u = MM f + b

    consistent with :func:`assemble_poisson2d`'s conventions: Dirichlet
    faces contribute the penalty + symmetry terms
    int_f ubc (gtau v - n.grad v); Neumann faces contribute int_f qbc v.
    """
    K, n_p, n_fp, n_faces = ctx.k_elem, ctx.n_p, ctx.n_fp, ctx.n_faces
    Dr, Ds = np.asarray(ctx.Dr), np.asarray(ctx.Ds)
    fmask = np.asarray(ctx.fmask)
    rx, ry = np.asarray(ctx.rx), np.asarray(ctx.ry)
    sx, sy = np.asarray(ctx.sx), np.asarray(ctx.sy)
    sJ = np.asarray(ctx.sJ).reshape(K, n_faces, n_fp)
    nx = np.asarray(ctx.nx).reshape(K, n_faces, n_fp)
    ny = np.asarray(ctx.ny).reshape(K, n_faces, n_fp)
    fscale = np.asarray(ctx.fscale).reshape(K, n_faces, n_fp)
    bc_table = np.asarray(ctx.bc_table)
    ubc = np.asarray(ubc).reshape(K, n_faces, n_fp)
    qbc = np.asarray(qbc).reshape(K, n_faces, n_fp)

    from ..specgrid.vandermonde import vandermonde_1d

    r = np.asarray(ctx.r)
    s = np.asarray(ctx.s)
    face_coord = (r, r, s) if n_faces == 3 else (r, s, r, s)
    mass_edge = []
    for f in range(n_faces):
        fr = face_coord[f][fmask[f]]
        v1d = vandermonde_1d(ctx.n_order, fr)
        mass_edge.append(np.linalg.inv(v1d @ v1d.T))

    b = np.zeros((K, n_p))
    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        for f in range(n_faces):
            tag = bc_table[k, f]
            if tag == 0:
                continue
            fm = fmask[f]
            mass_f = mass_edge[f] * sJ[k, f, 0]
            if tag in neumann_tags:
                b[k, fm] += mass_f @ qbc[k, f]
            elif tag in dirichlet_tags:
                hinv = fscale[k, f, 0]
                gtau = 100.0**2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv
                ndotdx = nx[k, f, 0] * Dx[fm, :] + ny[k, f, 0] * Dy[fm, :]
                b[k, fm] += gtau * (mass_f @ ubc[k, f])
                b[k, :] -= ndotdx.T @ (mass_f @ ubc[k, f])
    return b
