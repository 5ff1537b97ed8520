"""SEM/CG Poisson path tests: matrix-free device solve + host oracle."""
import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla

from blitzdg_jax.mesh import box_triangles
from blitzdg_jax.ops.sem import (
    assemble_sem_poisson,
    sem_boundary_nodes,
    sem_load_vector,
    sem_num_nodes,
    sem_poisson_op,
    sem_scatter,
)
from blitzdg_jax.solvers.krylov import CONV_SUCCESS, cg
from blitzdg_jax.specgrid.triangle import build_triangle_context


def setup_ctx():
    return build_triangle_context(3, box_triangles(5, 5))


def test_scatter_gather_consistency():
    ctx = setup_ctx()
    n = sem_num_nodes(ctx)
    # a continuous function scattered to DG nodes agrees at coincident nodes
    x = np.asarray(ctx.x).reshape(-1)
    y = np.asarray(ctx.y).reshape(-1)
    gi = np.asarray(ctx.gather_ids)
    u_sem = jnp.asarray(np.sin(x[gi]) * np.cos(y[gi]))
    u_dg = sem_scatter(ctx, u_sem)
    np.testing.assert_allclose(
        np.asarray(u_dg).reshape(-1), np.sin(x) * np.cos(y), atol=1e-12
    )


def test_sem_solve_manufactured_cg():
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y), u=0 on the boundary, via the
    matrix-free SEM operator and CG."""
    ctx = setup_ctx()
    n = sem_num_nodes(ctx)
    mask = np.zeros(n, dtype=bool)
    mask[sem_boundary_nodes(ctx)] = True
    mask = jnp.asarray(mask)

    f = 2.0 * np.pi**2 * jnp.sin(np.pi * ctx.x) * jnp.sin(np.pi * ctx.y)
    b = sem_load_vector(ctx, f, mask)
    res = cg(lambda v: sem_poisson_op(ctx, v, mask), b, tol=1e-10, maxiter=2000)
    assert int(res.flag) == CONV_SUCCESS

    x = np.asarray(ctx.x).reshape(-1)
    y = np.asarray(ctx.y).reshape(-1)
    gi = np.asarray(ctx.gather_ids)
    uex = np.sin(np.pi * x[gi]) * np.sin(np.pi * y[gi])
    err = np.max(np.abs(np.asarray(res.x) - uex))
    assert err < 6e-3, err


def test_sem_oracle_matches_matrix_free():
    ctx = setup_ctx()
    n = sem_num_nodes(ctx)
    A, Msem = assemble_sem_poisson(ctx)
    mask_np = np.zeros(n, dtype=bool)
    mask_np[sem_boundary_nodes(ctx)] = True
    mask = jnp.asarray(mask_np)

    rng = np.random.default_rng(3)
    v = rng.normal(size=n)
    v[mask_np] = 0.0
    mf = np.asarray(sem_poisson_op(ctx, jnp.asarray(v), mask))
    direct = A @ v
    free = ~mask_np
    np.testing.assert_allclose(mf[free], direct[free], atol=1e-9)


def test_sem_direct_solve():
    ctx = setup_ctx()
    n = sem_num_nodes(ctx)
    A, Msem = assemble_sem_poisson(ctx)
    bset = sem_boundary_nodes(ctx)
    free = np.setdiff1d(np.arange(n), bset)

    x = np.asarray(ctx.x).reshape(-1)
    y = np.asarray(ctx.y).reshape(-1)
    gi = np.asarray(ctx.gather_ids)
    f = 2.0 * np.pi**2 * np.sin(np.pi * x[gi]) * np.sin(np.pi * y[gi])
    b = Msem @ f
    u = np.zeros(n)
    u[free] = spla.spsolve(A[np.ix_(free, free)].tocsc(), b[free])
    uex = np.sin(np.pi * x[gi]) * np.sin(np.pi * y[gi])
    assert np.max(np.abs(u - uex)) < 6e-3
