"""Matrix-free Krylov solvers in pure JAX: CG and restarted GMRES.

Device-resident replacements for the reference's header-only GMRES
(/root/reference/include/GMRESSolver.hpp:212-430: right-preconditioned
restarts, modified Gram-Schmidt, Givens-free least-squares finish, ConvFlag
taxonomy) and for the LAPACK/UMFPACK direct solvers it leans on.

Design notes:
 - everything is `lax.while_loop`/`fori_loop` with static shapes; the
   Krylov basis is a dense (m+1, n) array in device memory;
 - dot products are collective-aware: pass ``axis_name`` when running
   INSIDE `shard_map` over an element-sharded vector and every reduction
   (MGS dots, norms, stagnation predicate) becomes a local partial + one
   `lax.psum`/`psum`-of-bool across devices — the sharded-GMRES contract of
   SURVEY.md §2.9 (reference dots: GMRESSolver.hpp:302-306). Without
   ``axis_name`` (plain jit over pjit-sharded arrays) XLA already lowers
   `jnp.vdot` to the same psum;
 - solvers operate on flat vectors; callers flatten (K, Np) fields; batch
   over scenarios with `jax.vmap`;
 - convergence bookkeeping mirrors the reference ConvFlag taxonomy where it
   is meaningful for fixed-shape execution (converged / maxits / breakdown).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# Convergence flags (reference analog: GMRESSolver.hpp:64-75).
CONV_SUCCESS = 0
CONV_MAXITS = 1
CONV_BREAKDOWN = 2
CONV_INF_OR_NAN = 3
CONV_DIVERGED = 4  # residual grew past div_tol * ||r0|| (GMRESSolver.hpp:67)
CONV_STAGNATION = 5  # |dx_i| <= stg_tol*|x_i| for all i (GMRESSolver.hpp:416-427)
# recurrence claimed convergence but the TRUE residual b - A x misses tol
# (reference: the post-loop true-residual verification, GMRESSolver.hpp:71)
CONV_TRUE_RNRM = 6


class SolveResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray  # iterations (CG) or outer restarts (GMRES)
    relres: jnp.ndarray
    flag: jnp.ndarray


def _reducers(axis_name: str | None):
    """(dot, norm, all) reductions — global over the sharding axis when
    running inside shard_map, plain otherwise."""
    if axis_name is None:
        return (
            jnp.vdot,
            jnp.linalg.norm,
            jnp.all,
        )

    def dot(a, b):
        return jax.lax.psum(jnp.vdot(a, b), axis_name)

    def norm(a):
        return jnp.sqrt(jax.lax.psum(jnp.vdot(a, a).real, axis_name))

    def all_(pred):
        # all-true iff no shard saw a violation
        return jax.lax.psum(jnp.sum(~pred), axis_name) == 0

    return dot, norm, all_


def cg(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    precon: Callable | None = None,
    axis_name: str | None = None,
) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    ``axis_name``: name of the shard_map axis the vector is sharded over;
    reductions then ride `lax.psum` (see module docstring)."""
    dot, norm, _ = _reducers(axis_name)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precon is None:
        precon = lambda v: v

    bnorm = norm(b)
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)

    r0 = b - matvec(x0)
    z0 = precon(r0)
    rn0 = norm(r0)
    # (x, r, z, p, rz, it, broke, best residual norm, best iterate)
    state0 = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0),
              jnp.asarray(False), rn0, x0)

    def cond(state):
        _, r, *_, it, broke, _, _ = state
        return (~broke) & (norm(r) / bnorm > tol) & (it < maxiter)

    def body(state):
        x, r, z, p, rz, it, _, rmin, xbest = state
        Ap = matvec(p)
        pAp = dot(p, Ap)
        # Breakdown/divergence guards (reference analog: the GMRESSolver.hpp
        # ConvFlag taxonomy). On a semi-definite operator — or in low
        # precision — roundoff pushes p into the nullspace: pAp -> 0 makes
        # alpha explode instantly, and a residual nullspace component makes
        # x grow without bound gradually. Catch both: stop on non-positive
        # pAp, and stop when the residual norm has grown far past its best,
        # returning the best iterate seen.
        ok = jnp.isfinite(pAp) & (pAp.real > 0)
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rn = norm(r)
        improved = rn < rmin
        xbest = jnp.where(improved, x, xbest)
        rmin = jnp.minimum(rn, rmin)
        diverging = ~jnp.isfinite(rn) | (rn > 1e4 * rmin)
        z = precon(r)
        rz_new = dot(r, z)
        beta = jnp.where(ok, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, z, p, jnp.where(ok, rz_new, rz), it + 1,
                ~ok | diverging, rmin, xbest)

    x, r, *_, it, broke, rmin, xbest = jax.lax.while_loop(cond, body, state0)
    rn = norm(r)
    use_best = ~jnp.isfinite(rn) | (rmin < rn)
    x = jnp.where(use_best, xbest, x)
    relres_rec = jnp.where(use_best, rmin, rn) / bnorm
    # TRUE-residual verification (one extra matvec — reference true_rnrm,
    # GMRESSolver.hpp:71): the recurrence r drifts from b - A x under
    # roundoff/ill-conditioning; report the true relres, and flag the case
    # where the recurrence claimed success but the true residual disagrees.
    relres = norm(b - matvec(x)) / bnorm
    flag = jnp.where(
        relres <= tol,
        CONV_SUCCESS,
        jnp.where(
            ~jnp.isfinite(relres),
            CONV_INF_OR_NAN,
            jnp.where(
                relres_rec <= tol,
                CONV_TRUE_RNRM,
                jnp.where(broke, CONV_BREAKDOWN, CONV_MAXITS),
            ),
        ),
    )
    return SolveResult(x=x, iters=it, relres=relres, flag=flag)


def gmres(
    matvec: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    tol: float = 1e-6,
    restart: int = 30,
    maxiter: int = 100,
    precon: Callable | None = None,
    div_tol: float = 1e5,
    stg_tol: float = 1e-12,
    axis_name: str | None = None,
) -> SolveResult:
    """Right-preconditioned restarted GMRES(m).

    Arnoldi with modified Gram-Schmidt; the small (m+1, m) Hessenberg least
    squares is solved densely per cycle (tiny, replicated, stays on device).
    ``maxiter`` counts outer restart cycles (reference defaults kspaceSz=30,
    maxits=100, relTol=1e-6, divTol=1e5, stgTol=1e-12 —
    GMRESSolver.hpp:94-108). One matvec per cycle maintains the true
    residual (it seeds the next cycle's Krylov space — same matvec count as
    the reference's restart path, GMRESSolver.hpp:392-398).

    Termination taxonomy mirrors the reference ConvFlag enum
    (GMRESSolver.hpp:64-75): success / maxits / inf_or_nan, plus diverged
    (``||r|| >= div_tol*||r0||``, :364) and stagnation with the reference's
    exact per-cycle predicate (:416-427): stagnant unless some component has
    ``x_j != 0`` and ``|dx_j| > stg_tol*|x_j|`` (components at exactly zero
    never veto stagnation).

    ``axis_name``: shard_map axis for element-sharded vectors — every MGS
    dot product and norm becomes a psum (SURVEY.md §2.9).
    """
    dot, norm, all_ = _reducers(axis_name)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precon is None:
        precon = lambda v: v

    n = b.shape[0]
    m = restart
    dtype = b.dtype

    bnorm = norm(b)
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)

    def arnoldi_cycle(x, r):
        beta = norm(r)

        V = jnp.zeros((m + 1, n), dtype=dtype)
        R = jnp.zeros((m + 1, m), dtype=dtype)  # Givens-triangularized H
        cs = jnp.zeros((m,), dtype=dtype)
        sn = jnp.zeros((m,), dtype=dtype)
        g = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))

        # Arnoldi with progressive Givens rotations (the reference's own
        # scheme, GMRESSolver.hpp:319-344): after step j the rotated rhs
        # component |g[j+1]| IS the cycle residual norm, so the while_loop
        # exits the moment it clears tol — no further matvecs, and the MGS
        # loop runs only the i <= j triangle (VERDICT r2 item 8: the old
        # masked form did m+1 dots per step and all m matvecs per cycle).
        def step_cond(carry):
            _, _, _, _, _, j, done = carry
            return (j < m) & ~done

        def step_body(carry):
            V, R, cs, sn, g, j, done = carry
            w = matvec(precon(V[j]))

            def mgs(i, wh):
                w, h = wh
                hij = dot(V[i], w)
                w = w - hij * V[i]
                h = h.at[i].set(hij)
                return (w, h)

            h = jnp.zeros((m + 1,), dtype=dtype)
            w, h = jax.lax.fori_loop(0, j + 1, mgs, (w, h))
            hnext = norm(w)
            h = h.at[j + 1].set(hnext)
            V = V.at[j + 1].set(w / jnp.where(hnext > 1e-30, hnext, 1.0))

            # apply the accumulated rotations to the new column, then the
            # new rotation zeroing h[j+1] (drotg analog, LinAlgHelpers.cpp)
            def rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hip = -sn[i] * h[i] + cs[i] * h[i + 1]
                return h.at[i].set(hi).at[i + 1].set(hip)

            h = jax.lax.fori_loop(0, j, rot, h)
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            safe = jnp.where(denom > 0, denom, 1.0)
            c_new = jnp.where(denom > 0, h[j] / safe, 1.0)
            s_new = jnp.where(denom > 0, h[j + 1] / safe, 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            h = h.at[j].set(c_new * h[j] + s_new * h[j + 1]).at[j + 1].set(0.0)
            R = R.at[:, j].set(h)
            g = g.at[j + 1].set(-s_new * g[j]).at[j].set(c_new * g[j])

            res_est = jnp.abs(g[j + 1])
            done = (res_est <= tol * bnorm) | (hnext <= 1e-30)
            return (V, R, cs, sn, g, j + 1, done)

        V, R, cs, sn, g, j_used, _ = jax.lax.while_loop(
            step_cond, step_body,
            (V, R, cs, sn, g, jnp.asarray(0), jnp.asarray(False)))

        # back-substitute R[:j_used, :j_used] y = g[:j_used] — columns past
        # j_used get unit diagonal + zero rhs so their y is exactly 0
        # (R is replicated across shards: built from psum'd dots)
        idx = jnp.arange(m)
        live = idx < j_used
        Rsq = R[:m, :]
        Rsq = jnp.where(live[None, :] & live[:, None], Rsq,
                        jnp.eye(m, dtype=dtype))
        gm = jnp.where(live, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rsq, gm, lower=False)
        dx = precon(V[:m].T @ y)
        x_new = x + dx
        # TRUE residual, not the Givens recurrence estimate |g[j+1]| — this
        # is the reference's true_rnrm verification (GMRESSolver.hpp:71)
        # done every cycle (it also seeds the next cycle's Krylov space)
        r_new = b - matvec(x_new)
        res = norm(r_new)
        # stagnation (GMRESSolver.hpp:416-427): stagnant unless some
        # component with x_j != 0 moved by more than stg_tol relative
        stag = all_((x_new == 0) | (jnp.abs(dx) <= stg_tol * jnp.abs(x_new)))
        rec_ok = jnp.abs(g[j_used]) <= tol * bnorm  # recurrence's own claim
        return x_new, r_new, res, stag, rec_ok

    r0 = b - matvec(x0)
    res0 = norm(r0)
    false_ = jnp.asarray(False)
    state0 = (x0, r0, res0, jnp.asarray(0), false_, false_, false_)

    def cond(state):
        _, _, res, it, stag, div, _ = state
        return ((res / bnorm > tol) & (it < maxiter) & jnp.isfinite(res)
                & ~stag & ~div)

    def body(state):
        x, r, _, it, _, _, _ = state
        x, r, res, stag, rec_ok = arnoldi_cycle(x, r)
        div = res >= div_tol * res0
        return (x, r, res, it + 1, stag, div, rec_ok)

    x, _, res, it, stag, div, rec_ok = jax.lax.while_loop(cond, body, state0)
    relres = res / bnorm
    flag = jnp.where(
        relres <= tol,
        CONV_SUCCESS,
        jnp.where(
            ~jnp.isfinite(relres),
            CONV_INF_OR_NAN,
            jnp.where(
                div,
                CONV_DIVERGED,
                jnp.where(
                    stag,
                    CONV_STAGNATION,
                    # the last cycle's Givens recurrence claimed convergence
                    # but the true residual disagrees: the reference's
                    # true_rnrm flag (GMRESSolver.hpp:71) — distinct from an
                    # honest maxits exhaustion
                    jnp.where(rec_ok, CONV_TRUE_RNRM, CONV_MAXITS),
                ),
            ),
        ),
    )
    return SolveResult(x=x, iters=it, relres=relres, flag=flag)
