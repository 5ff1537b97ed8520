"""Inhomogeneous boundary-condition load vectors for the assembled SIP path
(reference buildBcRhs analog) — mixed Dirichlet/Neumann manufactured
solutions, the heat2d implicit path."""
import numpy as np
import scipy.sparse.linalg as spla

from blitzdg_jax.context import BC_DIRICHLET, BC_NEUMAN, BC_WALL
from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.poisson import assemble_bc_rhs, assemble_poisson2d
from blitzdg_jax.specgrid.triangle import build_triangle_context


def face_midpoints(mesh):
    fv1 = mesh.etov
    fv2 = mesh.etov[:, [1, 2, 0]]
    return 0.5 * (mesh.verts[fv1] + mesh.verts[fv2])  # (K, 3, 2)


def test_inhomogeneous_dirichlet():
    """Laplace problem with u = x^2 + y^2 on the boundary: -Lap u = -4."""
    mesh = box_triangles(6, 6)
    ctx = build_triangle_context(3, mesh, dtype=None)
    OP, MM = assemble_poisson2d(ctx)

    uex = ctx.x**2 + ctx.y**2
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    uflat = uex.reshape(-1)
    ubc = uflat[np.asarray(ctx.vmapM)].reshape(K, n_tr)
    qbc = np.zeros((K, n_tr))

    b = assemble_bc_rhs(ctx, ubc, qbc)
    f = np.full(ctx.k_elem * ctx.n_p, -4.0)
    u = spla.spsolve(OP.tocsc(), MM @ f + b.reshape(-1))
    err = np.max(np.abs(u - uflat))
    assert err < 1e-8, err  # u is quadratic: exact at N=3


def test_mixed_dirichlet_neumann():
    """u = x^2: Dirichlet on y=+-1 faces, Neumann (q = n.grad u = 2x nx)
    on x=+-1 faces; -Lap u = -2."""
    mesh = box_triangles(5, 5)
    mids = face_midpoints(mesh)
    bc = mesh.bc_type.copy()
    boundary = bc > 0
    on_x = np.abs(np.abs(mids[:, :, 0]) - 1.0) < 1e-12
    bc[boundary & on_x] = BC_NEUMAN
    bc[boundary & ~on_x] = BC_DIRICHLET
    mesh.set_bc_type(bc)

    ctx = build_triangle_context(3, mesh, dtype=None)
    OP, MM = assemble_poisson2d(ctx)

    uex = ctx.x**2
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    ubc = uex.reshape(-1)[np.asarray(ctx.vmapM)].reshape(K, n_tr)
    # q = n . grad u = 2 x nx at the face nodes
    xface = ctx.x.reshape(-1)[np.asarray(ctx.vmapM)].reshape(K, n_tr)
    qbc = 2.0 * xface * np.asarray(ctx.nx)

    b = assemble_bc_rhs(ctx, ubc, qbc)
    f = np.full(ctx.k_elem * ctx.n_p, -2.0)
    u = spla.spsolve(OP.tocsc(), MM @ f + b.reshape(-1))
    err = np.max(np.abs(u - uex.reshape(-1)))
    assert err < 1e-7, err


def test_heat2d_implicit_steps():
    """Implicit heat equation (MM + kappa dt OP) p1 = MM p0 + kappa dt b
    (reference heat2d.py:148-168): decays toward the boundary-driven
    steady state; stays finite and bounded by the data."""
    mesh = box_triangles(5, 5)
    ctx = build_triangle_context(2, mesh, dtype=None)
    OP, MM = assemble_poisson2d(ctx)

    kappa, dt = 1.0, 1e-2
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    # hot left wall: ubc = 1 on x=-1, 0 elsewhere
    xface = ctx.x.reshape(-1)[np.asarray(ctx.vmapM)].reshape(K, n_tr)
    ubc = np.where(np.abs(xface + 1.0) < 1e-10, 1.0, 0.0)
    b = assemble_bc_rhs(ctx, ubc, np.zeros_like(ubc)).reshape(-1)

    A = (MM + kappa * dt * OP).tocsc()
    lu = spla.splu(A)
    p = np.zeros(ctx.k_elem * ctx.n_p)
    for _ in range(50):
        p = lu.solve(MM @ p + kappa * dt * b)
    assert np.all(np.isfinite(p))
    # discontinuous corner data gives a Gibbs overshoot; bounded modestly
    assert p.max() <= 1.3 and p.min() >= -0.3
    # temperature rises near the hot wall
    near_left = ctx.x.reshape(-1) < -0.8
    assert p[near_left].mean() > 0.05
