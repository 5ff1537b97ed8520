"""Dense-operator shallow-water RHS: the small-mesh MPC fast path.

Specialization with no reference analog: for small meshes
(K up to a few hundred — the MPC regime of thousands of scenarios on a
K=40-ish horizon model), the interface trace extraction *including the wall
reflection BC* is a fixed LINEAR map of the state. We compile it once into
dense (n_tr*K, Np*K) matrices so the per-step gathers become matmuls
batched over scenarios.

The wall reflection huP = huM - 2 nx (nx huM + ny hvM) mixes the momentum
components, so the momentum '+' traces are a 2x2 block of operators.

Use `sw2d_rhs_dense` with states batched (B, K, Np); it is bitwise-
equivalent to `sw2d_rhs` (verified in tests) for wall-only BCs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import dg_op
from ..context import BC_WALL, DGContext2D
from .sw2d import SWPhysics, SWState, _safe_norm


class DenseTraceOps(NamedTuple):
    SM: jnp.ndarray  # (n_trK, n_pK): '-' trace selection
    SP: jnp.ndarray  # (n_trK, n_pK): '+' trace selection (h field)
    PPuu: jnp.ndarray  # momentum '+' traces with wall reflection folded in
    PPuv: jnp.ndarray
    PPvu: jnp.ndarray
    PPvv: jnp.ndarray


def build_dense_trace_ops(ctx: DGContext2D, dtype=None) -> DenseTraceOps:
    K, n_p = ctx.k_elem, ctx.n_p
    n_tr = ctx.n_faces * ctx.n_fp
    nT, nV = K * n_tr, K * n_p
    vmapM = np.asarray(ctx.vmapM).reshape(-1)
    vmapP = np.asarray(ctx.vmapP).reshape(-1)
    nx = np.asarray(ctx.nx).reshape(-1)
    ny = np.asarray(ctx.ny).reshape(-1)

    SM = np.zeros((nT, nV))
    SP = np.zeros((nT, nV))
    SM[np.arange(nT), vmapM] = 1.0
    SP[np.arange(nT), vmapP] = 1.0

    wall = np.zeros(nT, dtype=bool)
    idx = np.asarray(ctx.bc_maps.idx[BC_WALL])
    msk = np.asarray(ctx.bc_maps.mask[BC_WALL])
    wall[idx[msk]] = True

    # wall rows: huP = (1 - 2 nx^2) huM - 2 nx ny hvM  (and symmetric for v)
    PPuu = SP.copy()
    PPvv = SP.copy()
    PPuv = np.zeros_like(SP)
    PPvu = np.zeros_like(SP)
    w = np.flatnonzero(wall)
    PPuu[w] = (1.0 - 2.0 * nx[w] ** 2)[:, None] * SM[w]
    PPuv[w] = (-2.0 * nx[w] * ny[w])[:, None] * SM[w]
    PPvu[w] = (-2.0 * nx[w] * ny[w])[:, None] * SM[w]
    PPvv[w] = (1.0 - 2.0 * ny[w] ** 2)[:, None] * SM[w]

    if dtype is None:
        dtype = ctx.x.dtype
    to = lambda a: jnp.asarray(a, dtype=dtype)
    return DenseTraceOps(SM=to(SM), SP=to(SP), PPuu=to(PPuu), PPuv=to(PPuv),
                         PPvu=to(PPvu), PPvv=to(PPvv))


@dg_op
def sw2d_rhs_dense(
    ctx: DGContext2D,
    ops: DenseTraceOps,
    state: SWState,
    t,
    phys: SWPhysics,
    tidal_forcing=None,
) -> SWState:
    """Shallow-water RHS with dense trace operators — full coastal physics
    (round-4: the r3 NotImplementedError guard is gone): wall reflection in
    the trace operators, optional tidal BC_OUT forcing, hydrostatic-
    reconstruction well-balanced star fluxes when phys.H is present
    (same derivation as ops.sw2d._lf_flux_jumps), bed-slope/drag/Coriolis.

    State fields: (..., K, Np); trace extraction is (..., n_pK) @ OP.T —
    with a leading scenario batch this is one big matmul.
    """
    from ..context import BC_OUT

    K, n_fp, n_faces = ctx.k_elem, ctx.n_fp, ctx.n_faces
    n_tr = n_faces * n_fp
    g = phys.g
    h, hu, hv = state
    lead = h.shape[:-2]

    hf = h.reshape(*lead, -1)
    huf = hu.reshape(*lead, -1)
    hvf = hv.reshape(*lead, -1)

    hM = hf @ ops.SM.T
    hP = hf @ ops.SP.T
    huM = huf @ ops.SM.T
    hvM = hvf @ ops.SM.T
    huP = huf @ ops.PPuu.T + hvf @ ops.PPuv.T
    hvP = huf @ ops.PPvu.T + hvf @ ops.PPvv.T

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    if tidal_forcing is not None:
        # prescribe total depth on BC_OUT trace nodes (sw2d_rhs analog)
        obc = jnp.zeros((K * n_tr,), dtype=hP.dtype)
        ob_idx = ctx.bc_maps.idx[BC_OUT]
        ob_mask = ctx.bc_maps.mask[BC_OUT]
        obc = obc.at[ob_idx].set(jnp.where(ob_mask, 1.0, obc[ob_idx]))
        h_bc = jnp.asarray(tidal_forcing(t), dtype=hP.dtype)
        hP = hP + obc * (h_bc - hP)

    wb = phys.H is not None and phys.well_balanced
    if wb:
        # hydrostatic-reconstruction star variables (ops.sw2d flux deriv.)
        Hflat = phys.H.reshape(-1)
        HMt = Hflat[jnp.asarray(ctx.vmapM).reshape(-1)]
        HPt = Hflat[jnp.asarray(ctx.vmapP).reshape(-1)]
        uM, vM = huM / hM, hvM / hM
        uP, vP = huP / hP, hvP / hP
        bstar = jnp.maximum(-HMt, -HPt)
        hMs = jnp.maximum(0.0, hM - HMt - bstar)
        hPs = jnp.maximum(0.0, hP - HPt - bstar)
        corr = (hM - hMs) * (uM * nxf + vM * nyf)

        def flux_uv(hh, uu, vv):
            p = 0.5 * g * hh * hh
            return (hh * uu, hh * uu * uu + p, hh * uu * vv,
                    hh * vv, hh * uu * vv, hh * vv * vv + p)

        F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(hMs, uM, vM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(hPs, uP, vP)
        spdM = _safe_norm(uM, vM) + jnp.sqrt(g * hMs)
        spdP = _safe_norm(uP, vP) + jnp.sqrt(g * hPs)
        dh, dhu, dhv = hMs - hPs, F1M - F1P, G1M - G1P
    else:
        def flux(hh, hhu, hhv):
            inv_h = 1.0 / hh
            F1, G1 = hhu, hhv
            F2 = hhu * hhu * inv_h + 0.5 * g * hh * hh
            G2 = hhu * hhv * inv_h
            G3 = hhv * hhv * inv_h + 0.5 * g * hh * hh
            return F1, F2, G2, G1, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux(hM, huM, hvM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux(hP, huP, hvP)
        spdM = _safe_norm(huM / hM, hvM / hM) + jnp.sqrt(g * hM)
        spdP = _safe_norm(huP / hP, hvP / hP) + jnp.sqrt(g * hP)
        dh, dhu, dhv = hM - hP, huM - huP, hvM - hvP
        corr = None

    spd = jnp.maximum(spdM, spdP).reshape(*lead, K * n_faces, n_fp)
    lam = jnp.max(spd, axis=-1, keepdims=True)
    lam = jnp.broadcast_to(lam, spd.shape).reshape(*lead, K * n_tr)

    d1 = 0.5 * ((F1M - F1P) * nxf + (G1M - G1P) * nyf - lam * dh)
    d2 = 0.5 * ((F2M - F2P) * nxf + (G2M - G2P) * nyf - lam * dhu)
    d3 = 0.5 * ((F3M - F3P) * nxf + (G3M - G3P) * nyf - lam * dhv)
    if corr is not None:
        d1 = d1 + corr
        d2 = d2 + corr * uM
        d3 = d3 + corr * vM

    def vol_flux(hh, hhu, hhv):
        inv_h = 1.0 / hh
        F2 = hhu * hhu * inv_h + 0.5 * g * hh * hh
        G2 = hhu * hhv * inv_h
        G3 = hhv * hhv * inv_h + 0.5 * g * hh * hh
        return hhu, F2, G2, hhv, G2, G3

    F1, F2, F3, G1, G2, G3 = vol_flux(h, hu, hv)

    def div(F, G):
        Fr, Fs = F @ ctx.Dr.T, F @ ctx.Ds.T
        Gr, Gs = G @ ctx.Dr.T, G @ ctx.Ds.T
        return ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs

    surf = lambda d: (ctx.fscale * d.reshape(*lead, K, n_tr)) @ ctx.lift.T
    rhs1 = -div(F1, G1) + surf(d1)
    rhs2 = -div(F2, G2) + surf(d2)
    rhs3 = -div(F3, G3) + surf(d3)

    if phys.Hx is not None:
        rhs2 = rhs2 + g * h * phys.Hx
        rhs3 = rhs3 + g * h * phys.Hy
    if phys.cd != 0.0:
        u, v = hu / h, hv / h
        norm_u = _safe_norm(u, v)
        rhs2 = rhs2 - phys.cd * norm_u * u
        rhs3 = rhs3 - phys.cd * norm_u * v
    if phys.f_cor != 0.0:
        rhs2 = rhs2 + phys.f_cor * hv
        rhs3 = rhs3 - phys.f_cor * hu

    return SWState(h=rhs1, hu=rhs2, hv=rhs3)
