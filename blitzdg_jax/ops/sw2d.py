"""2D nonlinear shallow-water equations on triangles (conservative form).

The MPC dynamics core. Functional parity targets:
 - sw2d-simple (src/sw2d-simple/main.cpp:181-356): conservative (h, hu, hv),
   per-face trace-max Lax-Friedrichs flux, wall-reflection BCs, SSP-RK2 with
   modal filter, adaptive dt from Fscale * wavespeed.
 - full sw2d (src/sw2d/main.cpp:279-484): bathymetry bed-slope source terms,
   quadratic bottom drag, Coriolis, tidal open-boundary forcing with
   hydrostatic-reconstruction well-balancing, sponge-layer relaxation.
   (The reference's v-momentum drag sign defect noted in SURVEY.md §"defects"
   is NOT replicated: drag enters both momentum equations with -CD|u|u.)

One RHS evaluation is: 2 trace gathers per field + elementwise flux algebra
+ 12 (Np x Np) x (K x Np) matmuls + 3 Lift matmuls — XLA fuses the algebra
around the matmuls; everything is batched over the element axis.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import struct
from ..config import dg_op
from ..context import BC_OUT, BC_WALL, DGContext2D


class SWState(NamedTuple):
    """Conservative shallow-water state, each (K, Np) (or leading-batched)."""

    h: jnp.ndarray
    hu: jnp.ndarray
    hv: jnp.ndarray


@struct.dataclass
class SWPhysics:
    """Physical configuration (reference analog: SW2d.hpp:15-30 params)."""

    g: float = struct.field(static=True, default=9.81)
    cd: float = struct.field(static=True, default=0.0)  # bottom drag
    f_cor: float = struct.field(static=True, default=0.0)  # Coriolis
    # bathymetry fields; None for flat-bottom problems
    H: jnp.ndarray | None = None  # still-water depth (K, Np)
    Hx: jnp.ndarray | None = None  # bed slopes (K, Np)
    Hy: jnp.ndarray | None = None
    sponge: jnp.ndarray | None = None  # relaxation coefficient (K, Np)
    # hydrostatic-reconstruction well-balancing at faces; active only when
    # bathymetry (H) is present (reference sw2d/main.cpp:356-368, 419-421)
    well_balanced: bool = struct.field(static=True, default=True)


def _traces(ctx: DGContext2D, f: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    return ctx.surface_trace(f)


def _safe_norm(u, v):
    """sqrt(u^2+v^2) with a zero (not NaN) gradient at the origin — required
    for differentiable rollouts through lake-at-rest states."""
    r2 = u * u + v * v
    r = jnp.sqrt(jnp.where(r2 > 0.0, r2, 1.0))
    return jnp.where(r2 > 0.0, r, 0.0)


def _lf_flux_jumps(g, n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP,
                   HM=None, HP=None):
    """Strong-form flux jumps (F(UM) - F̂)·n with per-face trace-max
    Lax-Friedrichs stabilization.

    Without bathymetry traces (HM/HP None) this is the plain LF flux of
    sw2d-simple (reference src/sw2d-simple/main.cpp:262-312). With them it
    applies **hydrostatic-reconstruction well-balancing** (Audusse et al.;
    reference intent src/sw2d/main.cpp:356-368 star variables and :419-421
    pressure-flux correction — the shipped code's momentum rescale and
    correction are no-ops because hM/huM are overwritten first; here the
    scheme is derived correctly):

      b* = max(bM, bP),  h⋆ = max(0, h + b - b*),  u⋆ = u (velocity kept)
      F̂ = ½(F(U⋆M)+F(U⋆P))·n - ½λ(q⋆P-q⋆M) + (0, g/2(hM²-h⋆M²)·n)

    In strong form the pressure corrections cancel against F(UM)-F(U⋆M),
    leaving purely advective consistency terms (hM-h⋆M)(u·n)M·(1, uM, vM).
    At a lake at rest (h+b continuous, u=0) every term vanishes exactly —
    machine-zero RHS over arbitrarily steep/discontinuous bathymetry.
    """
    if HM is not None:
        uM, vM = huM / hM, hvM / hM
        uP, vP = huP / hP, hvP / hP
        bstar = jnp.maximum(-HM, -HP)
        hMs = jnp.maximum(0.0, hM - HM - bstar)
        hPs = jnp.maximum(0.0, hP - HP - bstar)
        corr = (hM - hMs) * (uM * nxf + vM * nyf)

        # flux tensors from (h⋆, u, v) — no division by the (possibly dry)
        # starred depth anywhere
        def flux_uv(hh, uu, vv):
            p = 0.5 * g * hh * hh
            F1, G1 = hh * uu, hh * vv
            F2 = hh * uu * uu + p
            G2 = hh * uu * vv
            G3 = hh * vv * vv + p
            return F1, F2, G2, G1, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(hMs, uM, vM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(hPs, uP, vP)
        spdM = _safe_norm(uM, vM) + jnp.sqrt(g * hMs)
        spdP = _safe_norm(uP, vP) + jnp.sqrt(g * hPs)
        dh, dhu, dhv = hMs - hPs, F1M - F1P, G1M - G1P
    else:
        def flux(hh, hhu, hhv):
            inv_h = 1.0 / hh
            p = 0.5 * g * hh * hh
            F2 = hhu * hhu * inv_h + p
            G2 = hhu * hhv * inv_h
            G3 = hhv * hhv * inv_h + p
            return hhu, F2, G2, hhv, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux(hM, huM, hvM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux(hP, huP, hvP)
        spdM = _safe_norm(huM / hM, hvM / hM) + jnp.sqrt(g * hM)
        spdP = _safe_norm(huP / hP, hvP / hP) + jnp.sqrt(g * hP)
        dh, dhu, dhv = hM - hP, huM - huP, hvM - hvP
        corr = None

    spd = jnp.maximum(spdM, spdP).reshape(-1, n_fp)
    lam = jnp.max(spd, axis=1, keepdims=True)  # max over each face
    lam = jnp.broadcast_to(lam, spd.shape).reshape(-1)

    dflux1 = 0.5 * ((F1M - F1P) * nxf + (G1M - G1P) * nyf - lam * dh)
    dflux2 = 0.5 * ((F2M - F2P) * nxf + (G2M - G2P) * nyf - lam * dhu)
    dflux3 = 0.5 * ((F3M - F3P) * nxf + (G3M - G3P) * nyf - lam * dhv)
    if corr is not None:
        dflux1 = dflux1 + corr
        dflux2 = dflux2 + corr * uM
        dflux3 = dflux3 + corr * vM
    return dflux1, dflux2, dflux3


@dg_op
def sw2d_rhs(
    ctx: DGContext2D,
    state: SWState,
    t,
    phys: SWPhysics,
    tidal_forcing=None,
) -> SWState:
    """Strong-form DG RHS with per-face trace-max Lax-Friedrichs flux.

    ``tidal_forcing(t)`` optionally returns the prescribed total water depth
    for BC_OUT open-boundary nodes (reference sw2d main.cpp:347-353).

    When bathymetry is present (phys.H) and phys.well_balanced, the face
    fluxes use hydrostatic-reconstruction star variables with the pressure
    correction (see _lf_flux_jumps; reference sw2d/main.cpp:356-368,419-421)
    so lake-at-rest states over arbitrary — even inter-element-discontinuous
    — bathymetry produce a machine-zero RHS.
    """
    K, n_fp, n_faces = ctx.k_elem, ctx.n_fp, ctx.n_faces
    n_tr = n_faces * n_fp
    g = phys.g

    h, hu, hv = state
    hM, hP = _traces(ctx, h)
    huM, huP = _traces(ctx, hu)
    hvM, hvP = _traces(ctx, hv)

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Wall BC: reflect the normal momentum component.
    wall_idx = ctx.bc_maps.idx[BC_WALL]
    wall_mask = ctx.bc_maps.mask[BC_WALL]
    un2 = 2.0 * (huM[wall_idx] * nxf[wall_idx] + hvM[wall_idx] * nyf[wall_idx])
    huP = huP.at[wall_idx].set(
        jnp.where(wall_mask, huM[wall_idx] - un2 * nxf[wall_idx], huP[wall_idx])
    )
    hvP = hvP.at[wall_idx].set(
        jnp.where(wall_mask, hvM[wall_idx] - un2 * nyf[wall_idx], hvP[wall_idx])
    )

    # Open-boundary tidal forcing: prescribe h on BC_OUT nodes.
    if tidal_forcing is not None:
        ob_idx = ctx.bc_maps.idx[BC_OUT]
        ob_mask = ctx.bc_maps.mask[BC_OUT]
        h_bc = tidal_forcing(t)
        h_bc = jnp.broadcast_to(jnp.asarray(h_bc, dtype=hP.dtype), ob_idx.shape)
        hP = hP.at[ob_idx].set(jnp.where(ob_mask, h_bc, hP[ob_idx]))

    # Bathymetry traces for hydrostatic-reconstruction well-balancing.
    HMt = HPt = None
    if phys.H is not None and phys.well_balanced:
        HMt, HPt = _traces(ctx, phys.H)

    dflux1, dflux2, dflux3 = _lf_flux_jumps(
        g, n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP, HMt, HPt
    )

    # Volume flux divergence.
    def flux(hh, hhu, hhv):
        inv_h = 1.0 / hh
        F1, G1 = hhu, hhv
        F2 = hhu * hhu * inv_h + 0.5 * g * hh * hh
        G2 = hhu * hhv * inv_h
        F3 = G2
        G3 = hhv * hhv * inv_h + 0.5 * g * hh * hh
        return F1, F2, F3, G1, G2, G3

    F1, F2, F3, G1, G2, G3 = flux(h, hu, hv)

    def div(F, G):
        Fr, Fs = F @ ctx.Dr.T, F @ ctx.Ds.T
        Gr, Gs = G @ ctx.Dr.T, G @ ctx.Ds.T
        return ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs

    surf = lambda d: (ctx.fscale * d.reshape(K, n_tr)) @ ctx.lift.T
    rhs1 = -div(F1, G1) + surf(dflux1)
    rhs2 = -div(F2, G2) + surf(dflux2)
    rhs3 = -div(F3, G3) + surf(dflux3)

    # Source terms: bed slope, quadratic drag, Coriolis
    # (reference sw2d main.cpp:460-483; drag sign corrected on v-momentum).
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


def sw2d_timestep(ctx: DGContext2D, state: SWState, g: float, cfl: float):
    """Adaptive dt = CFL / ((N+1)^2 * 0.5 * max(|Fscale| * spdM))
    (reference sw2d-simple main.cpp:108-109). Global max — becomes a
    `lax.pmax` when the element axis is sharded."""
    h, hu, hv = state
    spd = _safe_norm(hu / h, hv / h) + jnp.sqrt(g * h)
    spdM = spd.reshape(-1)[ctx.vmapM.reshape(-1)]
    fsc = jnp.max(jnp.abs(ctx.fscale.reshape(-1)) * spdM)
    return cfl / ((ctx.n_order + 1) ** 2 * 0.5 * fsc)


@dg_op
def apply_filter(ctx: DGContext2D, f: jnp.ndarray) -> jnp.ndarray:
    """Modal exponential filter application (one batched matmul)."""
    return f @ ctx.filter.T


def sponge_relax(state: SWState, phys: SWPhysics, dt) -> SWState:
    """Sponge-layer relaxation toward rest near open boundaries
    (reference sw2d main.cpp:218-224 with buildSpongeCoeff :517-553)."""
    if phys.sponge is None:
        return state
    fac = 1.0 / (1.0 + dt * phys.sponge)
    h_rest = phys.H if phys.H is not None else state.h
    return SWState(
        h=h_rest + (state.h - h_rest) * fac,
        hu=state.hu * fac,
        hv=state.hv * fac,
    )
