"""1D nodal DG discretization on a uniform line-segment grid.

Host-side setup producing a frozen :class:`~blitzdg_jax.context.DGContext1D`.
Functional parity target: reference Nodes1DProvisioner
(/root/reference/src/Nodes1DProvisioner.cpp:57-307): LGL nodes, V / Vinv,
Dr = Vr V^{-1}, Lift = V V^T E, affine x-grid, J = Dr x, rx = 1/J,
Fscale = 1/J at face nodes, endpoint normals -1/+1, and the vmapM/vmapP
interface maps. Built natively element-major (K, Np) — not a port of the
reference's column-major index arithmetic.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..context import DGContext1D
from .jacobi import gauss_lobatto_points
from .vandermonde import dmatrix_1d, vandermonde_1d


def build_nodes1d(
    n_order: int,
    k_elem: int,
    xmin: float,
    xmax: float,
    dtype=jnp.float64,
) -> DGContext1D:
    n_p = n_order + 1
    n_faces, n_fp = 2, 1

    # Reference element: LGL nodes, Vandermonde, differentiation.
    r = gauss_lobatto_points(0.0, 0.0, n_order)
    V = vandermonde_1d(n_order, r)
    Vinv = np.linalg.inv(V)
    Dr = dmatrix_1d(n_order, r, V)

    # Lift = V V^T E, E picks the endpoint nodes (faces are points in 1D).
    E = np.zeros((n_p, n_faces * n_fp))
    E[0, 0] = 1.0
    E[n_p - 1, 1] = 1.0
    lift = V @ (V.T @ E)

    # Physical grid: uniform elements, affine map. Element-major (K, Np).
    width = (xmax - xmin) / k_elem
    k_idx = np.arange(k_elem)
    x = xmin + width * (k_idx[:, None] + 0.5 * (r[None, :] + 1.0))

    # Metric: J = dx/dr (constant per element for affine, but computed
    # nodally as Dr @ x like the reference for exact parity).
    J = x @ Dr.T
    rx = 1.0 / J
    fmask = np.array([0, n_p - 1])
    fscale = rx[:, fmask]  # 1/J at the two endpoint nodes
    nx = np.tile(np.array([-1.0, 1.0]), (k_elem, 1))

    # Interface maps. Face f of element k touches neighbor k-1 (f=0) / k+1
    # (f=1); at the domain ends the map is self-referential (boundary).
    vmapM = (k_idx[:, None] * n_p + fmask[None, :]).astype(np.int32)
    vmapP = np.empty_like(vmapM)
    mapP = np.empty_like(vmapM)
    for k in range(k_elem):
        # left face: neighbor's right endpoint
        if k > 0:
            vmapP[k, 0] = (k - 1) * n_p + (n_p - 1)
            mapP[k, 0] = (k - 1) * 2 + 1
        else:
            vmapP[k, 0] = vmapM[k, 0]
            mapP[k, 0] = k * 2 + 0
        # right face: neighbor's left endpoint
        if k < k_elem - 1:
            vmapP[k, 1] = (k + 1) * n_p + 0
            mapP[k, 1] = (k + 1) * 2 + 0
        else:
            vmapP[k, 1] = vmapM[k, 1]
            mapP[k, 1] = k * 2 + 1

    if dtype is None:  # host-only context (numpy f64; for oracles/assembly)
        to_dev = lambda a: np.asarray(a, dtype=np.float64)
    else:
        to_dev = lambda a: jnp.asarray(a, dtype=dtype)
    return DGContext1D(
        n_order=n_order,
        n_p=n_p,
        k_elem=k_elem,
        n_faces=n_faces,
        n_fp=n_fp,
        r=to_dev(r),
        V=to_dev(V),
        Vinv=to_dev(Vinv),
        Dr=to_dev(Dr),
        lift=to_dev(lift),
        x=to_dev(x),
        J=to_dev(J),
        rx=to_dev(rx),
        nx=to_dev(nx),
        fscale=to_dev(fscale),
        vmapM=jnp.asarray(vmapM),
        vmapP=jnp.asarray(vmapP),
        mapP=jnp.asarray(mapP),
        fmask=jnp.asarray(fmask.astype(np.int32)),
        mapI=0,
        mapO=2 * k_elem - 1,
        vmapI=0,
        vmapO=n_p * k_elem - 1,
    )
