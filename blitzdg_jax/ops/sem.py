"""Continuous-Galerkin (SEM) Poisson path via gather/scatter assembly.

Functional parity target: Poisson2DSparseMatrix::buildSEMPoissonOperator
(src/Poisson2DSparseMatrix.cpp:493-588), which compresses the DG operator
through the uniquetol DG<->SEM maps (TriangleNodesProvisioner.cpp:1009-1019).

Design: the SEM operator is applied MATRIX-FREE on device —
scatter the unique-node vector to DG nodes (`take`), apply the per-element
stiffness action (batched matmuls), and gather-add back with
`segment_sum`. Dirichlet boundary nodes are enforced by masking. A host
scipy assembly is provided as the direct-solve/verification path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import dg_op
from ..context import DGContext2D


def sem_num_nodes(ctx: DGContext2D) -> int:
    return int(ctx.gather_ids.shape[0])


def sem_boundary_nodes(ctx: DGContext2D) -> np.ndarray:
    """Unique-node ids lying on the physical boundary."""
    scatter = np.asarray(ctx.scatter_ids)
    vb = np.asarray(ctx.vmapB)[np.asarray(ctx.maskB)]
    return np.unique(scatter[vb])


def sem_scatter(ctx: DGContext2D, u_sem: jnp.ndarray) -> jnp.ndarray:
    """(n_unique,) -> (K, Np) continuous nodal field."""
    return u_sem[ctx.scatter_ids].reshape(ctx.k_elem, ctx.n_p)


def sem_gather_add(ctx: DGContext2D, f_dg: jnp.ndarray) -> jnp.ndarray:
    """(K, Np) -> (n_unique,) by summing coincident-node contributions."""
    n = sem_num_nodes(ctx)
    return jax.ops.segment_sum(
        f_dg.reshape(-1), ctx.scatter_ids, num_segments=n
    )


@dg_op
def sem_poisson_op(
    ctx: DGContext2D, u_sem: jnp.ndarray, dirichlet_mask: jnp.ndarray
) -> jnp.ndarray:
    """Matrix-free SEM stiffness action: A u (SPD on the free nodes).

    ``dirichlet_mask`` (n_unique,) bool marks constrained nodes; the
    operator acts as identity there (so CG solves with bc values folded
    into the RHS).
    """
    u_sem = jnp.where(dirichlet_mask, 0.0, u_sem)
    u = sem_scatter(ctx, u_sem)
    ux, uy = ctx.grad(u)
    M = ctx.Vinv.T @ ctx.Vinv
    # weak local stiffness: Dx^T (J M) Dx u  via gradient-space weighting
    wx = ctx.J * (ux @ M.T)
    wy = ctx.J * (uy @ M.T)
    # transpose-gradient: (K, Np)
    out = (
        (ctx.rx * wx + ctx.ry * wy) @ ctx.Dr
        + (ctx.sx * wx + ctx.sy * wy) @ ctx.Ds
    )
    out_sem = sem_gather_add(ctx, out)
    return jnp.where(dirichlet_mask, u_sem, out_sem)


@dg_op
def sem_load_vector(ctx: DGContext2D, f: jnp.ndarray, dirichlet_mask) -> jnp.ndarray:
    """Assemble the SEM load vector of a nodal forcing f: gather of J M f,
    zeroed on Dirichlet nodes."""
    M = ctx.Vinv.T @ ctx.Vinv
    b = sem_gather_add(ctx, ctx.J * (f @ M.T))
    return jnp.where(dirichlet_mask, 0.0, b)


def assemble_sem_poisson(ctx: DGContext2D):
    """Host scipy assembly of the SEM stiffness and mass over unique nodes
    (direct-solve oracle). Dirichlet handling left to the caller."""
    import scipy.sparse as sp

    K, n_p = ctx.k_elem, ctx.n_p
    Dr, Ds = np.asarray(ctx.Dr), np.asarray(ctx.Ds)
    V = np.asarray(ctx.V)
    M = np.linalg.inv(V @ V.T)
    rx, ry = np.asarray(ctx.rx), np.asarray(ctx.ry)
    sx, sy = np.asarray(ctx.sx), np.asarray(ctx.sy)
    J = np.asarray(ctx.J)
    scatter = np.asarray(ctx.scatter_ids).reshape(K, n_p)
    n = sem_num_nodes(ctx)

    rows, cols, avals, mvals = [], [], [], []
    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        Ak = J[k, 0] * (Dx.T @ M @ Dx + Dy.T @ M @ Dy)
        Mk = J[k, 0] * M
        gid = scatter[k]
        rows.append(np.repeat(gid, n_p))
        cols.append(np.tile(gid, n_p))
        avals.append(Ak.reshape(-1))
        mvals.append(Mk.reshape(-1))

    A = sp.csr_matrix(
        (np.concatenate(avals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    Msem = sp.csr_matrix(
        (np.concatenate(mvals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A, Msem
