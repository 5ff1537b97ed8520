"""Precomputed-table halo exchange over `lax.ppermute`.

The domain-decomposition analog of a CP/ring-attention shift (SURVEY.md
§2.9): each element shard owns a contiguous block of K/n_shards elements;
the only data another shard ever needs is the (Nfp-wide) '-' trace of the
faces on the cut. At setup we build, per shard and per ring offset d, the
exact list of local faces some shard at distance d needs; at run time each
offset is ONE `lax.ppermute` of a fixed-size face buffer around the ring.
Communication is proportional to the cut (the halo), not the domain —
unlike an all_gather exchange, which would ship every trace to every
shard.

Requires the face-granular structure of mapP (context.face_trace_structure)
— every conforming mesh has it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import dg_op
from ..context import BC_OUT, BC_WALL, DGContext2D, face_trace_structure
from ..ops.sw2d import SWPhysics, SWState, _lf_flux_jumps, _safe_norm


class HaloPlan(NamedTuple):
    """Static halo-exchange tables. Arrays lead with the shard axis so they
    can be passed into shard_map with P('element', ...) — each shard gets
    its own row."""

    # (n_shards, n_off, max_send): local face rows to send to the shard at
    # ring offset offs[d]; padded with 0 (sent but ignored by receivers)
    send_idx: jnp.ndarray
    # (n_shards, F_loc): row in [local faces | recv_0 | recv_1 | ...] that
    # feeds each local face's '+' trace
    psrc: jnp.ndarray
    # (n_shards, F_loc): lane-reverse flag per local face
    pflip: jnp.ndarray
    offs: tuple  # static ring offsets with nonzero traffic
    n_shards: int
    max_send: int


def build_halo_plan(ctx: DGContext2D, n_shards: int) -> HaloPlan:
    """Host-side: derive send lists and '+'-source tables from the global
    face-neighbor structure. K must be divisible by n_shards (partition.py
    guarantees contiguous equal blocks)."""
    K, nf, n_fp = ctx.k_elem, ctx.n_faces, ctx.n_fp
    assert K % n_shards == 0, (K, n_shards)
    fts = face_trace_structure(ctx.mapP, n_fp)
    if fts is None:
        raise ValueError("mapP has no face-granular structure "
                         "(non-conforming mesh?); the halo exchange "
                         "requires conforming faces")
    face_nbr, face_flip = fts  # global face ids / flip flags, (K*nf,)
    return _plan_from_struct(face_nbr, face_flip, n_shards,
                             (K // n_shards) * nf)


def build_gauss_halo_plan(gauss, n_shards: int) -> HaloPlan:
    """Halo plan for the GAUSS-face trace exchange of the curved pipeline:
    same construction as build_halo_plan but over gauss.mapP's face
    structure (NG-wide face rows, reversed '+' ordering — reference
    TriangleNodesProvisioner.cpp:337-344). Lets sw2d_curved_rhs run
    element-sharded: the cubature volume terms are shard-local, only this
    exchange crosses the cut (SURVEY.md §2.9)."""
    K, ntr = gauss.mapP.shape
    nf = ntr // gauss.n_gauss
    assert K % n_shards == 0, (K, n_shards)
    fts = face_trace_structure(gauss.mapP, gauss.n_gauss)
    if fts is None:
        raise ValueError("gauss.mapP has no face-granular structure")
    face_nbr, face_flip = fts
    return _plan_from_struct(face_nbr, face_flip, n_shards,
                             (K // n_shards) * nf)


def _plan_from_struct(face_nbr, face_flip, n_shards: int,
                      f_loc: int) -> HaloPlan:
    owner = face_nbr // f_loc

    # send[d][t]: ordered dict local_row -> slot, for shard t sending to
    # shard (t+d) % n_shards
    send: dict[int, list[dict]] = {}
    psrc = np.zeros((n_shards, f_loc), np.int64)
    remote_ref: list[list[tuple]] = [[] for _ in range(n_shards)]

    for s in range(n_shards):
        base = s * f_loc
        for i in range(f_loc):
            nbr = int(face_nbr[base + i])
            t = int(owner[base + i])
            if t == s:
                psrc[s, i] = nbr - t * f_loc  # local row
            else:
                d = (s - t) % n_shards
                slots = send.setdefault(d, [dict() for _ in range(n_shards)])
                row = nbr - t * f_loc
                slot = slots[t].setdefault(row, len(slots[t]))
                remote_ref[s].append((i, d, slot))

    offs = tuple(sorted(send.keys()))
    max_send = max(
        (len(slots[t]) for d in offs for t in range(n_shards)
         for slots in (send[d],)),
        default=1,
    )
    max_send = max(max_send, 1)

    send_idx = np.zeros((n_shards, max(len(offs), 1), max_send), np.int32)
    for di, d in enumerate(offs):
        for t in range(n_shards):
            for row, slot in send[d][t].items():
                send_idx[t, di, slot] = row

    # remote sources index into the concatenated [local | recv_offs...] rows
    for s in range(n_shards):
        for i, d, slot in remote_ref[s]:
            di = offs.index(d)
            psrc[s, i] = f_loc + di * max_send + slot

    pflip = np.asarray(face_flip).reshape(n_shards, f_loc)
    return HaloPlan(
        send_idx=send_idx,
        psrc=psrc.astype(np.int32),
        pflip=pflip,
        offs=offs,
        n_shards=n_shards,
        max_send=max_send,
    )


def halo_tables(plan: HaloPlan):
    """Device copies of the per-shard tables — pass these through shard_map
    with P(axis) on the leading (shard) dim; the plan itself (static offs /
    shard count) is closed over."""
    return (jnp.asarray(plan.send_idx), jnp.asarray(plan.psrc),
            jnp.asarray(plan.pflip))


def _ppermute(x, axis_name, perm):
    """Injectable collective hook: the ONE call site every halo exchange
    goes through. examples/scaling_study.py overrides this (and asserts it
    fired) to measure the comm share of a step — patching here is robust
    to how jax.lax is imported."""
    return jax.lax.ppermute(x, axis_name, perm)


def halo_face_rows(rows, plan_row, plan: HaloPlan, axis_name: str,
                   halo_dtype=None):
    """'+' face rows from local '-' face rows (n_fields, F_loc, w): one
    ppermute per active ring offset, then per-face source gather + flip.
    Width-agnostic — w is Nfp for nodal traces, NG for Gauss traces.

    All ppermutes are ISSUED before any receive is consumed, so XLA's
    latency-hiding scheduler can overlap the exchange with whatever
    independent (volume) compute the caller has pending — the halo analog
    of comm/compute overlap in ring attention.

    ``halo_dtype`` (e.g. jnp.bfloat16) compresses the shipped traces: only
    the cross-shard buffer is cast, local faces keep full precision. The
    '+' trace is only flux-stabilization input, so bf16 halos trade
    ~1e-3-relative face-flux noise for half the interconnect bytes — opt-in."""
    n = plan.n_shards
    send_idx, psrc, pflip = plan_row
    parts = [rows]
    for di, d in enumerate(plan.offs):
        buf = jnp.take(rows, send_idx[di], axis=1)  # (nF, max_send, w)
        if halo_dtype is not None:
            buf = buf.astype(halo_dtype)
        recv = _ppermute(
            buf, axis_name, [(j, (j + d) % n) for j in range(n)]
        )
        parts.append(recv.astype(rows.dtype))
    comb = jnp.concatenate(parts, axis=1)
    out = jnp.take(comb, psrc, axis=1)  # (nF, F_loc, w)
    return jnp.where(pflip[None, :, None], out[..., ::-1], out)


def halo_traces(fields, ctx, plan_row, plan: HaloPlan, axis_name: str,
                halo_dtype=None):
    """'-' and '+' traces of a tuple of local (K_loc, Np) fields with
    cross-shard faces exchanged via one ppermute per active ring offset.
    plan_row: this shard's (send_idx, psrc, pflip) rows (leading shard axis
    already consumed by shard_map). Returns stacked (n_fields, F_loc*n_fp)."""
    n_fp = ctx.n_fp
    fm = ctx.fmask.reshape(-1)
    fMf = jnp.stack([f[:, fm] for f in fields]).reshape(len(fields), -1, n_fp)
    fP = halo_face_rows(fMf, plan_row, plan, axis_name, halo_dtype=halo_dtype)
    nF = len(fields)
    return fMf.reshape(nF, -1), fP.reshape(nF, -1)


def _localize_bc(g_idx, g_mask, my, local_size):
    """Localize replicated GLOBAL trace indices to this shard: entries owned
    elsewhere become out-of-range (dropped by scatter mode='drop')."""
    mine = g_mask & (g_idx // local_size == my)
    idx = jnp.where(mine, g_idx % local_size, local_size)
    safe = jnp.where(mine, idx, 0)
    return idx, safe, mine


@dg_op
def halo_sw2d_rhs(
    ctx: DGContext2D,
    state: SWState,
    t,
    phys: SWPhysics,
    tables,  # halo_tables(plan) rows, shard axis consumed by shard_map
    plan: HaloPlan,  # static metadata (offs, n_shards); closed over
    axis_name: str = "element",
    tidal_forcing=None,
    halo_dtype=None,
) -> SWState:
    """Full sw2d RHS for use INSIDE shard_map over the element axis, with
    ppermute halo exchange (communication is the halo, not the domain).
    ``halo_dtype`` optionally compresses the shipped '+'-trace buffers
    (see halo_face_rows) — bf16 halos halve interconnect bytes at ~1e-3 relative
    face-flux noise.

    Feature-parity with ops.sw2d.sw2d_rhs: wall reflection, BC_OUT tidal
    forcing (reference sw2d/main.cpp:347-353), hydrostatic-reconstruction
    well-balancing when phys.H is present (the bathymetry trace joins the
    halo exchange), and the bed-slope/drag/Coriolis sources — so the coastal
    workload runs element-sharded with results identical to single-device.

    ctx: per-shard context blocks (as in sharded_sw2d_rhs); `tables` must
    be passed through shard_map with P(axis) on their leading dim and
    arrive here with that leading length-1 axis intact. phys.H/Hx/Hy/sponge
    (when present) must be sharded P(axis, None) like the state."""
    K_loc = state.h.shape[0]
    n_tr = ctx.n_faces * ctx.n_fp
    g = phys.g
    my = jax.lax.axis_index(axis_name)

    wb = phys.H is not None and phys.well_balanced
    fields = tuple(state) + ((phys.H,) if wb else ())

    plan_row = tuple(a[0] for a in tables)
    fM, fP = halo_traces(fields, ctx, plan_row, plan, axis_name,
                         halo_dtype=halo_dtype)
    if wb:
        hM, huM, hvM, HMt = fM
        hP, huP, hvP, HPt = fP
    else:
        hM, huM, hvM = fM
        hP, huP, hvP = fP
        HMt = HPt = None

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)
    local_size = K_loc * n_tr

    # Wall BC: reflect the normal momentum component.
    wall_idx, safe, _ = _localize_bc(
        ctx.bc_maps.idx[BC_WALL], ctx.bc_maps.mask[BC_WALL], my, local_size
    )
    un2 = 2.0 * (huM[safe] * nxf[safe] + hvM[safe] * nyf[safe])
    huP = huP.at[wall_idx].set(huM[safe] - un2 * nxf[safe], mode="drop")
    hvP = hvP.at[wall_idx].set(hvM[safe] - un2 * nyf[safe], mode="drop")

    # Open-boundary tidal forcing: prescribe total depth on BC_OUT nodes.
    if tidal_forcing is not None:
        ob_idx, _, _ = _localize_bc(
            ctx.bc_maps.idx[BC_OUT], ctx.bc_maps.mask[BC_OUT], my, local_size
        )
        h_bc = jnp.broadcast_to(
            jnp.asarray(tidal_forcing(t), dtype=hP.dtype), ob_idx.shape
        )
        hP = hP.at[ob_idx].set(h_bc, mode="drop")

    dflux1, dflux2, dflux3 = _lf_flux_jumps(
        g, ctx.n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP, HMt, HPt
    )

    h, hu, hv = state

    def flux(hh, hhu, hhv):
        inv_h = 1.0 / hh
        F2 = hhu * hhu * inv_h + 0.5 * g * hh * hh
        G2 = hhu * hhv * inv_h
        G3 = hhv * hhv * inv_h + 0.5 * g * hh * hh
        return hhu, F2, G2, hhv, G2, G3

    F1, F2, F3, G1, G2, G3 = flux(h, hu, hv)

    def div(F, G):
        Fr, Fs = F @ ctx.Dr.T, F @ ctx.Ds.T
        Gr, Gs = G @ ctx.Dr.T, G @ ctx.Ds.T
        return ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs

    surf = lambda d: (ctx.fscale * d.reshape(K_loc, n_tr)) @ ctx.lift.T
    rhs1 = -div(F1, G1) + surf(dflux1)
    rhs2 = -div(F2, G2) + surf(dflux2)
    rhs3 = -div(F3, G3) + surf(dflux3)

    # Source terms (all shard-local; reference sw2d main.cpp:460-483).
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


@dg_op
def halo_poisson2d_op(
    ctx: DGContext2D,
    u: jnp.ndarray,
    tau,
    tables,
    plan: HaloPlan,
    axis_name: str = "element",
    dirichlet_tags=(3, 6),  # BC_WALL, BC_DIRICHLET
    neumann_tags=(7,),  # BC_NEUMAN
    symmetrize: bool = False,
) -> jnp.ndarray:
    """2D IP Laplacian INSIDE shard_map over the element axis — the sharded
    twin of ops.poisson.poisson2d_op, with the two trace exchanges (u, then
    the gradient pair) riding the ppermute halo tables. Combine with
    cg/gmres(axis_name=...) for a fully element-sharded elliptic solve
    (reference contract: GMRESSolver.hpp:278-430 dots -> psum, SURVEY §2.9).

    ``tau`` must be the GLOBAL penalty constant, computed once at setup
    ((N+1)^2 * max Fscale over the whole mesh) so results match the
    unsharded operator bitwise."""
    K_loc = u.shape[0]
    n_tr = ctx.n_faces * ctx.n_fp
    my = jax.lax.axis_index(axis_name)
    plan_row = tuple(a[0] for a in tables)
    local_size = K_loc * n_tr

    ux, uy = ctx.grad(u)

    (uM,), (uP,) = halo_traces((u,), ctx, plan_row, plan, axis_name)
    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Dirichlet: uP = -uM (zero trace)
    for tag in dirichlet_tags:
        idx, safe, _ = _localize_bc(
            ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag], my, local_size)
        uP = uP.at[idx].set(-uM[safe], mode="drop")

    du = uM - uP
    du_mat = du.reshape(K_loc, n_tr)

    # Auxiliary gradient with central flux: q = grad u - Lift(n du / 2)
    qx = ux - ((ctx.fscale * ctx.nx * du_mat * 0.5) @ ctx.lift.T)
    qy = uy - ((ctx.fscale * ctx.ny * du_mat * 0.5) @ ctx.lift.T)

    (uxM, uyM), (uxP, uyP) = halo_traces((ux, uy), ctx, plan_row, plan,
                                         axis_name)
    fm = ctx.fmask.reshape(-1)
    qxM = qx[:, fm].reshape(-1)
    qyM = qy[:, fm].reshape(-1)

    # Neumann: mirror the gradient so the normal component cancels.
    for tag in neumann_tags:
        idx, safe, _ = _localize_bc(
            ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag], my, local_size)
        un = uxM[safe] * nxf[safe] + uyM[safe] * nyf[safe]
        uxP = uxP.at[idx].set(uxM[safe] - 2.0 * nxf[safe] * un, mode="drop")
        uyP = uyP.at[idx].set(uyM[safe] - 2.0 * nyf[safe] * un, mode="drop")

    dqx = qxM - 0.5 * (uxM + uxP)
    dqy = qyM - 0.5 * (uyM + uyP)

    surf = (
        ctx.nx * dqx.reshape(K_loc, n_tr)
        + ctx.ny * dqy.reshape(K_loc, n_tr)
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


def halo_sw2d_timestep(ctx: DGContext2D, state: SWState, g: float, cfl: float,
                       axis_name: str = "element"):
    """Adaptive dt INSIDE shard_map: the per-shard face-max wavespeed is
    reduced with `lax.pmax` over the element axis (the sharded form of
    sw2d_timestep's global max; reference sw2d-simple main.cpp:108-109)."""
    h, hu, hv = state
    spd = _safe_norm(hu / h, hv / h) + jnp.sqrt(g * h)
    spdM = spd[:, ctx.fmask.reshape(-1)]  # local '-' trace, no halo needed
    fsc = jnp.max(jnp.abs(ctx.fscale) * spdM)
    fsc = jax.lax.pmax(fsc, axis_name)
    return cfl / ((ctx.n_order + 1) ** 2 * 0.5 * fsc)


@dg_op
def halo_sw2d_curved_rhs(
    ctx: DGContext2D,
    cub,  # CubatureContext2D, per-shard blocks
    gauss,  # GaussFaceContext2D, per-shard blocks (maps stay GLOBAL)
    state,  # SWStateTracer (h, hu, hv, hN), (K_loc, Np) fields
    t,
    phys: SWPhysics,
    tables,  # halo_tables(build_gauss_halo_plan(...)) rows
    plan: HaloPlan,
    axis_name: str = "element",
    tidal_forcing=None,
    zx=None,
    zy=None,
):
    """Element-sharded curved weak-form RHS (ops.sw2d_curved.sw2d_curved_rhs
    inside shard_map): cubature volume integrals and per-element mass
    inverses are shard-local; ONLY the Gauss-face '+' trace crosses the cut,
    via the ppermute halo over the Gauss plan (build_gauss_halo_plan).
    gauss.bc_idx stays global and is localized per shard."""
    from ..ops.sw2d_curved import SWStateTracer, _fluxes

    K_loc = state.h.shape[0]
    g = phys.g
    h, hu, hv, hN = state
    my = jax.lax.axis_index(axis_name)

    # --- volume: interpolate to cubature, weak derivatives (local) ---
    at_cub = lambda f: f @ cub.V.T
    ch, chu, chv, chN = at_cub(h), at_cub(hu), at_cub(hv), at_cub(hN)
    (F1, F2, F3, F4), (G1, G2, G3, G4) = _fluxes(ch, chu, chv, chN, g)

    def weak_div(F, G):
        tr = cub.W * (cub.rx * F + cub.ry * G)
        ts = cub.W * (cub.sx * F + cub.sy * G)
        return tr @ cub.Dr + ts @ cub.Ds

    MMRHS = [weak_div(F1, G1), weak_div(F2, G2), weak_div(F3, G3),
             weak_div(F4, G4)]

    # --- surface: Gauss traces with ppermute halo ---
    NG = gauss.n_gauss
    ntr = gauss.nx.shape[1]
    nf = ntr // NG
    plan_row = tuple(a[0] for a in tables)
    gM = jnp.stack([(f @ gauss.interp.T).reshape(K_loc * nf, NG)
                    for f in (h, hu, hv, hN)])
    gP = halo_face_rows(gM, plan_row, plan, axis_name)
    hM, huM, hvM, hNM = gM.reshape(4, -1)
    hP, huP, hvP, hNP = gP.reshape(4, -1)

    nxf = gauss.nx.reshape(-1)
    nyf = gauss.ny.reshape(-1)
    local_size = K_loc * ntr

    wall_idx, wall_safe, _ = _localize_bc(
        gauss.bc_idx[BC_WALL], gauss.bc_mask[BC_WALL], my, local_size)
    un2 = 2.0 * (huM[wall_safe] * nxf[wall_safe]
                 + hvM[wall_safe] * nyf[wall_safe])
    huP = huP.at[wall_idx].set(huM[wall_safe] - un2 * nxf[wall_safe],
                               mode="drop")
    hvP = hvP.at[wall_idx].set(hvM[wall_safe] - un2 * nyf[wall_safe],
                               mode="drop")
    if tidal_forcing is not None:
        ob_idx, ob_safe, ob_mine = _localize_bc(
            gauss.bc_idx[BC_OUT], gauss.bc_mask[BC_OUT], my, local_size)
        h_bc = jnp.broadcast_to(
            jnp.asarray(tidal_forcing(t), dtype=hP.dtype), ob_idx.shape)
        hP = hP.at[ob_idx].set(h_bc, mode="drop")

    (F1M, F2M, F3M, F4M), (G1M, G2M, G3M, G4M) = _fluxes(hM, huM, hvM, hNM, g)
    (F1P, F2P, F3P, F4P), (G1P, G2P, G3P, G4P) = _fluxes(hP, huP, hvP, hNP, g)

    spdM = _safe_norm(huM / hM, hvM / hM) + jnp.sqrt(g * hM)
    spdP = _safe_norm(huP / hP, hvP / hP) + jnp.sqrt(g * hP)
    spd = jnp.maximum(spdM, spdP).reshape(K_loc * nf, NG)
    lam = jnp.broadcast_to(jnp.max(spd, axis=1, keepdims=True),
                           spd.shape).reshape(-1)

    shape = (K_loc, ntr)
    fl = [
        (0.5 * ((FM + FP) * nxf + (GM + GP) * nyf
                + lam * (qM - qP))).reshape(shape)
        for FM, FP, GM, GP, qM, qP in (
            (F1M, F1P, G1M, G1P, hM, hP),
            (F2M, F2P, G2M, G2P, huM, huP),
            (F3M, F3P, G3M, G3P, hvM, hvP),
            (F4M, F4P, G4M, G4P, hNM, hNP),
        )
    ]
    MMRHS = [m - (gauss.W * f) @ gauss.interp for m, f in zip(MMRHS, fl)]

    inv = lambda mm: jnp.einsum("kij,kj->ki", cub.MMinv, mm)
    RHS1, RHS2, RHS3, RHS4 = (inv(m) for m in MMRHS)

    u, v = hu / h, hv / h
    cd_norm = phys.cd * _safe_norm(u, v)
    RHS2 = RHS2 + phys.f_cor * hv - cd_norm * u
    RHS3 = RHS3 - phys.f_cor * hu - cd_norm * v
    if zx is not None:
        RHS2 = RHS2 - g * h * zx
        RHS3 = RHS3 - g * h * zy

    return SWStateTracer(h=RHS1, hu=RHS2, hv=RHS3, hN=RHS4)
