"""Curved/over-integrated shallow water: weak-form cubature volume integrals
+ Gauss-node surface integrals + per-element mass inverses.

Functional parity target: swhelpers/rhs.py sw2dComputeRHS_curved (:6-176):
fields interpolated to cubature nodes, weak derivatives Dr^T W (rx F + ry G),
Gauss-node traces with central+LF flux 0.5((FM+FP).n + spd dh), per-element
mass solves, source terms (Coriolis, drag, bed slope). Includes a passive
tracer field hN like the reference's 4th equation. The reference's
v-momentum drag sign defect (rhs.py:172, SURVEY.md defects) is corrected.

Redesign: per-element mass inverses are precomputed (K, Np, Np) at
setup and applied as ONE batched matmul instead of per-element
Cholesky triangular solves in the hot loop; all stages are element-major
einsums XLA fuses around the gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import dg_op
from ..context import BC_WALL, DGContext2D
from ..specgrid.cubature import CubatureContext2D, GaussFaceContext2D
from .sw2d import SWPhysics, _safe_norm


class SWStateTracer(NamedTuple):
    h: jnp.ndarray
    hu: jnp.ndarray
    hv: jnp.ndarray
    hN: jnp.ndarray  # passive tracer (reference sw2d.py hN field)


def _fluxes(h, hu, hv, hN, g):
    inv_h = 1.0 / h
    u, v = hu * inv_h, hv * inv_h
    F1, G1 = hu, hv
    F2 = hu * u + 0.5 * g * h * h
    G2 = hu * v
    F3 = G2
    G3 = hv * v + 0.5 * g * h * h
    F4, G4 = hN * u, hN * v
    return (F1, F2, F3, F4), (G1, G2, G3, G4)


@dg_op
def sw2d_curved_rhs(
    ctx: DGContext2D,
    cub: CubatureContext2D,
    gauss: GaussFaceContext2D,
    state: SWStateTracer,
    t,
    phys: SWPhysics,
    zx: jnp.ndarray | None = None,  # bed slope d(z)/dx at nodal points
    zy: jnp.ndarray | None = None,
    tidal_forcing=None,  # callable t -> prescribed total depth on BC_OUT
    wetdry: bool = False,  # hydrostatic minmod reconstruction + desing.
    h_floor: float = 1e-3,
) -> SWStateTracer:
    """Weak-form RHS; state fields are (K, Np).

    ``wetdry=True`` (VERDICT r3 item 7: the reference's limiters were
    written FOR this curved driver, swhelpers/limiters.py + sw2d_curved.py)
    activates the wetting/drying treatment on the Gauss traces: hydrostatic
    minmod surface reconstruction of the face water columns (needs phys.H),
    Kurganov-Petrova desingularized velocities, the one-sided pressure
    correction g/2 (hM^2 - hM*^2) n of the Audusse scheme (explicit here
    because the weak form integrates F-hat itself, not F(UM) - F-hat), and
    a dry-cell mask on the bed-slope source. Pair with per-stage
    positivity limiting (ssprk2_step_curved_wetdry)."""
    K = ctx.k_elem
    g = phys.g
    h, hu, hv, hN = state

    eps2 = (4.0 * h_floor) ** 2

    def desing_inv(hh):
        return 2.0 * hh / (hh * hh + jnp.maximum(hh * hh, eps2))

    # --- volume: interpolate to cubature, weak derivatives ---
    at_cub = lambda f: f @ cub.V.T  # (K, Ncub)
    ch, chu, chv, chN = at_cub(h), at_cub(hu), at_cub(hv), at_cub(hN)
    if wetdry:
        inv_c = desing_inv(ch)
        cu, cv = chu * inv_c, chv * inv_c
        pr = 0.5 * g * ch * ch
        F1, G1 = chu, chv
        F2, G2 = ch * cu * cu + pr, ch * cu * cv
        F3, G3 = G2, ch * cv * cv + pr
        F4, G4 = chN * cu, chN * cv
    else:
        (F1, F2, F3, F4), (G1, G2, G3, G4) = _fluxes(ch, chu, chv, chN, g)

    def weak_div(F, G):
        tr = cub.W * (cub.rx * F + cub.ry * G)
        ts = cub.W * (cub.sx * F + cub.sy * G)
        return tr @ cub.Dr + ts @ cub.Ds  # (K, Np): Dr^T applied from right

    MMRHS1 = weak_div(F1, G1)
    MMRHS2 = weak_div(F2, G2)
    MMRHS3 = weak_div(F3, G3)
    MMRHS4 = weak_div(F4, G4)

    # --- surface: Gauss traces ---
    at_g = lambda f: (f @ gauss.interp.T).reshape(-1)  # flat (K*3NG,)
    gh, ghu, ghv, ghN = at_g(h), at_g(hu), at_g(hv), at_g(hN)
    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    hM, hP = gh[mM], gh[mP]
    huM, huP = ghu[mM], ghu[mP]
    hvM, hvP = ghv[mM], ghv[mP]
    hNM, hNP = ghN[mM], ghN[mP]

    nxf = gauss.nx.reshape(-1)
    nyf = gauss.ny.reshape(-1)

    wall = gauss.bc_idx[BC_WALL]
    wmask = gauss.bc_mask[BC_WALL]
    un2 = 2.0 * (huM[wall] * nxf[wall] + hvM[wall] * nyf[wall])
    huP = huP.at[wall].set(jnp.where(wmask, huM[wall] - un2 * nxf[wall], huP[wall]))
    hvP = hvP.at[wall].set(jnp.where(wmask, hvM[wall] - un2 * nyf[wall], hvP[wall]))

    # tidal open boundary on Gauss trace nodes (mirror of the nodal path,
    # reference sw2d/main.cpp:347-353): prescribe total depth on BC_OUT
    if tidal_forcing is not None:
        from ..context import BC_OUT

        ob = gauss.bc_idx[BC_OUT]
        omask = gauss.bc_mask[BC_OUT]
        h_bc = jnp.broadcast_to(
            jnp.asarray(tidal_forcing(t), dtype=hP.dtype), ob.shape)
        hP = hP.at[ob].set(jnp.where(omask, h_bc, hP[ob]))

    NG = gauss.n_gauss
    shape = (K, 3 * NG)
    if wetdry:
        from .limiters import surface_reconstruction

        gH = at_g(phys.H)
        HMt, HPt = gH[mM], gH[mP]
        etaM, etaP = hM - HMt, hP - HPt
        hMs, hPs = surface_reconstruction(etaM, hM, etaP, hP, h_floor)
        uM, vM = huM * desing_inv(hM), hvM * desing_inv(hM)
        uP, vP = huP * desing_inv(hP), hvP * desing_inv(hP)
        cNM, cNP = hNM * desing_inv(hM), hNP * desing_inv(hP)

        def flux_uv(hh, uu, vv, cc):
            pr = 0.5 * g * hh * hh
            return ((hh * uu, hh * uu * uu + pr, hh * uu * vv, hh * cc * uu),
                    (hh * vv, hh * uu * vv, hh * vv * vv + pr, hh * cc * vv))

        (F1M, F2M, F3M, F4M), (G1M, G2M, G3M, G4M) = flux_uv(hMs, uM, vM, cNM)
        (F1P, F2P, F3P, F4P), (G1P, G2P, G3P, G4P) = flux_uv(hPs, uP, vP, cNP)
        spdM = _safe_norm(uM, vM) + jnp.sqrt(g * hMs)
        spdP = _safe_norm(uP, vP) + jnp.sqrt(g * hPs)
        q1M, q1P = hMs, hPs
        q2M, q2P = F1M, F1P
        q3M, q3P = G1M, G1P
        q4M, q4P = hMs * cNM, hPs * cNP
        # one-sided Audusse pressure correction: the weak form integrates
        # F-hat itself, so the g/2 (hM^2 - hM*^2) n term is explicit
        pcorr = 0.5 * g * (hM * hM - hMs * hMs)
    else:
        (F1M, F2M, F3M, F4M), (G1M, G2M, G3M, G4M) = _fluxes(hM, huM, hvM, hNM, g)
        (F1P, F2P, F3P, F4P), (G1P, G2P, G3P, G4P) = _fluxes(hP, huP, hvP, hNP, g)
        spdM = _safe_norm(huM / hM, hvM / hM) + jnp.sqrt(g * hM)
        spdP = _safe_norm(huP / hP, hvP / hP) + jnp.sqrt(g * hP)
        q1M, q1P = hM, hP
        q2M, q2P = huM, huP
        q3M, q3P = hvM, hvP
        q4M, q4P = hNM, hNP
        pcorr = None

    spd = jnp.maximum(spdM, spdP).reshape(K * 3, NG)
    lam = jnp.broadcast_to(jnp.max(spd, axis=1, keepdims=True), spd.shape).reshape(-1)

    flux1 = (0.5 * ((F1M + F1P) * nxf + (G1M + G1P) * nyf + lam * (q1M - q1P))).reshape(shape)
    flux2 = (0.5 * ((F2M + F2P) * nxf + (G2M + G2P) * nyf + lam * (q2M - q2P))).reshape(shape)
    flux3 = (0.5 * ((F3M + F3P) * nxf + (G3M + G3P) * nyf + lam * (q3M - q3P))).reshape(shape)
    flux4 = (0.5 * ((F4M + F4P) * nxf + (G4M + G4P) * nyf + lam * (q4M - q4P))).reshape(shape)
    if pcorr is not None:
        flux2 = flux2 + (pcorr * nxf).reshape(shape)
        flux3 = flux3 + (pcorr * nyf).reshape(shape)

    MMRHS1 = MMRHS1 - (gauss.W * flux1) @ gauss.interp
    MMRHS2 = MMRHS2 - (gauss.W * flux2) @ gauss.interp
    MMRHS3 = MMRHS3 - (gauss.W * flux3) @ gauss.interp
    MMRHS4 = MMRHS4 - (gauss.W * flux4) @ gauss.interp

    # --- per-element mass inverse: one batched matmul over K ---
    inv = lambda mm: jnp.einsum("kij,kj->ki", cub.MMinv, mm)
    RHS1 = inv(MMRHS1)
    RHS2 = inv(MMRHS2)
    RHS3 = inv(MMRHS3)
    RHS4 = inv(MMRHS4)

    # --- sources (drag sign corrected on v-momentum vs rhs.py:172) ---
    if wetdry:
        u, v = hu * desing_inv(h), hv * desing_inv(h)
    else:
        u, v = hu / h, hv / h
    cd_norm = phys.cd * _safe_norm(u, v)
    RHS2 = RHS2 + phys.f_cor * hv - cd_norm * u
    RHS3 = RHS3 - phys.f_cor * hu - cd_norm * v
    if zx is not None:
        if wetdry:
            # no bed-slope forcing in DRY cells (ops.sw2d_wetdry rationale)
            wet = jnp.where(h > 5.0 * h_floor, 1.0, 0.0)
            RHS2 = RHS2 - g * h * zx * wet
            RHS3 = RHS3 - g * h * zy * wet
        else:
            RHS2 = RHS2 - g * h * zx
            RHS3 = RHS3 - g * h * zy

    return SWStateTracer(h=RHS1, hu=RHS2, hv=RHS3, hN=RHS4)


def ssprk2_step_curved_wetdry(
    ctx: DGContext2D,
    cub: CubatureContext2D,
    gauss: GaussFaceContext2D,
    state: SWStateTracer,
    t,
    dt,
    phys: SWPhysics,
    zx=None,
    zy=None,
    h_floor: float = 1e-3,
    use_filter: bool = False,
) -> SWStateTracer:
    """Heun (true SSP-RK2) step of the CURVED weak-form dynamics with the
    per-stage Zhang-Shu positivity limiter + near-dry momentum taper —
    the curved-path twin of ops.sw2d_wetdry.ssprk2_step_wetdry (the
    reference's limiters target exactly this driver,
    swhelpers/limiters.py + sw2d_curved.py; VERDICT r3 item 7)."""
    from .limiters import positivity_preserving_limiter

    def limit(s: SWStateTracer) -> SWStateTracer:
        h, hu, hv = positivity_preserving_limiter(s.h, s.hu, s.hv,
                                                  h_floor=h_floor)
        taper = jnp.clip((h - h_floor) / (4.0 * h_floor), 0.0, 1.0)
        return SWStateTracer(h=h, hu=hu * taper, hv=hv * taper, hN=s.hN)

    def rhs(s, tt):
        r = sw2d_curved_rhs(ctx, cub, gauss, s, tt, phys, zx=zx, zy=zy,
                            wetdry=True, h_floor=h_floor)
        if use_filter:
            r = SWStateTracer(*(f @ ctx.filter.T for f in r))
        return r

    k1 = rhs(state, t)
    s1 = limit(SWStateTracer(*(u + dt * k for u, k in zip(state, k1))))
    k2 = rhs(s1, t + dt)
    s2 = SWStateTracer(*(0.5 * u + 0.5 * (u1 + dt * k)
                         for u, u1, k in zip(state, s1, k2)))
    return limit(s2)
