"""Batched, branch-free dual active-set LDP solver (the framework's core kernel).

A batched, accelerator-friendly re-design of the DAQP dual active-set algorithm (Arnstrom,
Bemporad, Axehill, IEEE TAC 2022; invoked by the reference at
src/utils.jl:268-283). Instead of the reference's sequential C iteration
with recursive LDL' up/downdates, every lane of a batch performs the same
fixed-shape masked iteration:

  1. solve the working-set KKT system through a masked m x m solve
     (inactive rows are replaced by identity rows, so the solve shape is
     static and thousands of lanes proceed in lockstep under ``vmap``);
  2. either take a partial step to the first blocking multiplier and drop
     that constraint, or accept the iterate and add the most violated
     constraint -- both outcomes are computed and selected per lane with
     ``where`` (no data-dependent control flow);
  3. repeat under ``lax.while_loop`` until every lane converges or the
     iteration budget is exhausted.

Double-sided constraints are handled DAQP-style with a signed multiplier:
active-at-upper requires lam >= 0, active-at-lower lam <= 0. Soft
constraints add ``rho_soft`` to the working-set diagonal (proximal soft
penalty, reference src/setup.jl:26); equality rows stay active with a
sign-free multiplier; immutable (infinite-bound) rows are never activated.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .ldp import LDPData

HIGHEST = jax.lax.Precision.HIGHEST


class LDPArrays(NamedTuple):
    """Device-resident solver arrays (a pytree; dtype set by the engine)."""

    G: jax.Array
    G_solve: jax.Array  # G + rho_soft * diag(is_soft)
    Dth: jax.Array
    du: jax.Array
    dl: jax.Array
    HinvET: jax.Array
    Uth_off: jax.Array
    u_off: jax.Array
    H: jax.Array
    f: jax.Array
    f_theta: jax.Array
    is_eq: jax.Array
    is_immutable: jax.Array
    is_soft: jax.Array
    is_binary: jax.Array
    up_finite: jax.Array
    lo_finite: jax.Array
    subset_inv: jax.Array | None  # (2^m, m, m) working-set inverse cache


class DualState(NamedTuple):
    lam: jax.Array    # (m,) signed multipliers
    active: jax.Array  # (m,) bool working set
    side: jax.Array   # (m,) bool, True = active at upper bound
    iters: jax.Array  # () int32
    done: jax.Array   # () bool
    infeas: jax.Array  # () bool: dual-unbounded ray found (primal infeasible)


class Solution(NamedTuple):
    U: jax.Array       # (n,) primal decision vector
    lam: jax.Array     # (m,)
    active: jax.Array  # (m,) bool
    side: jax.Array    # (m,) bool
    fval: jax.Array    # () objective value
    iters: jax.Array   # () int32
    status: jax.Array  # () int32: 1 = optimal, -1 = iteration limit, -3 = infeasible


def to_device_arrays(ldp: LDPData, dtype=jnp.float64, subset_inv=None) -> LDPArrays:
    cast = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
    G = cast(ldp.G)
    G_solve = G + jnp.diag(cast(np.asarray(ldp.rho_soft, dtype=np.float64)))
    return LDPArrays(
        G=G, G_solve=G_solve,
        Dth=cast(ldp.Dth), du=cast(ldp.du), dl=cast(ldp.dl),
        HinvET=cast(ldp.HinvET), Uth_off=cast(ldp.Uth_off), u_off=cast(ldp.u_off),
        H=cast(ldp.H), f=cast(ldp.f), f_theta=cast(ldp.f_theta),
        is_eq=jnp.asarray(ldp.is_eq), is_immutable=jnp.asarray(ldp.is_immutable),
        is_soft=jnp.asarray(ldp.is_soft), is_binary=jnp.asarray(ldp.is_binary),
        up_finite=jnp.asarray(ldp.up_finite), lo_finite=jnp.asarray(ldp.lo_finite),
        subset_inv=None if subset_inv is None else cast(subset_inv),
    )


def cold_state(m: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(lam, active, side) for a cold start; equalities are activated inside
    ``solve_single`` regardless, so zeros are valid everywhere."""
    return jnp.zeros(m), jnp.zeros(m, dtype=bool), jnp.ones(m, dtype=bool)


def _masked_solve(Gmask, rhs, use_cholesky: bool):
    """Solve the masked working-set system. Cholesky for symmetric problems
    (the masked matrix is SPD: active principal block + identity elsewhere);
    LU for the non-symmetric AVI (game MPC) case. A dtype-scaled ridge keeps degenerate working sets (linearly dependent
    active rows) finite; the perturbation is below the convergence
    tolerances and the final f64 polish solves the converged set exactly."""
    from jax.scipy.linalg import solve_triangular

    eps = jnp.finfo(Gmask.dtype).eps
    m = Gmask.shape[0]
    Gmask = Gmask + (100.0 * m * eps) * jnp.eye(m, dtype=Gmask.dtype)
    if use_cholesky:
        L = jnp.linalg.cholesky(Gmask)
        y = solve_triangular(L, rhs, lower=True)
        return solve_triangular(L.T, y, lower=False)
    return jnp.linalg.solve(Gmask, rhs)


def _active_set_loop(
    ldp: LDPArrays,
    du_t, dl_t, is_eq, immut,
    lam, active, side,
    *,
    max_iter: int,
    primal_tol: float,
    sign_tol: float,
    use_cholesky: bool,
    iters0=None,
    unroll: int = 0,
):
    """The branch-free masked dual active-set iteration (one precision).

    ``unroll > 0`` switches from an early-exit ``while_loop`` to a fixed
    ``scan`` of ``max_iter`` steps unrolled by that factor: every lane pays
    the full budget, but XLA fuses across iterations, collapsing the
    per-iteration kernel-dispatch overhead that dominates small problems.
    """
    dtype = ldp.G.dtype
    m = ldp.G.shape[0]
    idx = jnp.arange(m)
    # finite sentinel: 1e30 dominates every reachable fval/bound in both
    # f32 and f64 and keeps sentinel arithmetic free of inf/NaN
    big = jnp.asarray(min(float(jnp.finfo(dtype).max), 1e30), dtype)
    pow2 = jnp.asarray(2 ** np.arange(m), dtype=jnp.int32) if ldp.subset_inv is not None else None

    def body(s: DualState) -> DualState:
        lam, act, side, it, done, _infeas = s
        actf = act.astype(dtype)
        d_side = jnp.where(side, du_t, dl_t)
        rhs = -actf * d_side
        if ldp.subset_inv is not None:
            # gather the precomputed masked working-set inverse: one matvec
            mask_id = jnp.sum(jnp.where(act, pow2, 0))
            lam_star = jnp.dot(ldp.subset_inv[mask_id], rhs, precision=HIGHEST)
        else:
            # masked working-set KKT system: inactive rows become identity rows
            Gmask = ldp.G_solve * actf[:, None] * actf[None, :] + jnp.diag(1.0 - actf)
            lam_star = _masked_solve(Gmask, rhs, use_cholesky)

        # multipliers of removable active rows must satisfy the side's sign
        sign_viol = act & ~is_eq & jnp.where(side, lam_star < -sign_tol, lam_star > sign_tol)
        has_viol = jnp.any(sign_viol)

        # -- blocking step: move toward lam_star until the first multiplier
        #    crosses zero, then drop that constraint
        denom = lam - lam_star
        safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        alpha_i = jnp.where(sign_viol, lam / safe, big)
        jb = jnp.argmin(alpha_i)
        alpha = jnp.clip(alpha_i[jb], 0.0, 1.0)
        lam_B = lam + alpha * (lam_star - lam)
        lam_B = jnp.where(idx == jb, 0.0, lam_B)
        act_B = act & (idx != jb)

        # -- acceptance step: take lam_star, then add the most violated row
        c = jnp.dot(ldp.G, lam_star, precision=HIGHEST)
        slack_up = du_t + c
        slack_lo = -dl_t - c
        cand = ~act & ~immut
        v_up = jnp.where(cand, -slack_up, -big)
        v_lo = jnp.where(cand, -slack_lo, -big)
        v = jnp.maximum(v_up, v_lo)
        j = jnp.argmax(v)
        converged = v[j] <= primal_tol
        grow = (idx == j) & ~converged
        act_A = act | grow
        side_A = jnp.where(grow, v_up[j] >= v_lo[j], side)
        lam_A = jnp.where(act_A, lam_star, 0.0)

        new_lam = jnp.where(has_viol, lam_B, lam_A)
        new_act = jnp.where(has_viol, act_B, act_A)
        new_side = jnp.where(has_viol, side, side_A)
        new_done = done | (~has_viol & converged)

        lam = jnp.where(done, lam, new_lam)
        act = jnp.where(done, act, new_act)
        side = jnp.where(done, side, new_side)
        return DualState(lam, act, side, it + jnp.int32(~done), new_done, s.infeas)

    def cond(s: DualState):
        return (~s.done) & (s.iters < max_iter)

    it0 = jnp.int32(0) if iters0 is None else iters0
    init = DualState(lam, active, side, it0, jnp.asarray(False), jnp.asarray(False))
    if unroll > 0:
        final, _ = jax.lax.scan(
            lambda s, _: (body(s), None), init, None, length=max_iter, unroll=unroll
        )
        return final
    return jax.lax.while_loop(cond, body, init)


def _masked_inverse(Gmask, use_cholesky: bool = True):
    """Explicit inverse of the masked working-set system, traced under
    HIGHEST matmul precision (f32 dots inside the decomposition would
    otherwise be allowed to run at reduced precision)."""
    eps = jnp.finfo(Gmask.dtype).eps
    m = Gmask.shape[0]
    Gmask = Gmask + (100.0 * m * eps) * jnp.eye(m, dtype=Gmask.dtype)
    eye = jnp.eye(m, dtype=Gmask.dtype)
    with jax.default_matmul_precision("highest"):
        if use_cholesky:
            from jax.scipy.linalg import cho_solve

            L = jnp.linalg.cholesky(Gmask)
            return cho_solve((L, True), eye)
        return jnp.linalg.solve(Gmask, eye)


def _active_set_loop_iu(
    ldp: LDPArrays,
    du_t, dl_t, is_eq, immut,
    lam, active, side,
    *,
    max_iter: int,
    primal_tol: float,
    sign_tol: float,
    iters0=None,
    return_R: bool = False,
):
    """Masked dual active-set iteration with O(m^2) recursive inverse
    updates -- the lockstep analog of DAQP's recursive LDL' up/downdates
    (reference algorithm, SURVEY.md N1). With ``return_R`` the final
    carried inverse is returned for use as an iterative-refinement
    preconditioner by the finishing tier.

    The working set changes by exactly one row per iteration, so the
    masked KKT matrix changes by a symmetric rank-2 correction
    M' = M +/- U C U' with U = [e_ch, v], v = act_after * G[:, ch]
    (v_ch = 0), C = [[G_chch - 1, 1], [1, 0]]. The carried inverse R is
    updated by Woodbury: R' = R -/+ (R U)(C^-1 +/- U' R U)^-1 (R U)' --
    two matvecs and an outer product instead of an O(m^3) factorization.

    Candidate additions follow Goldfarb-Idnani (the scheme DAQP's dual
    method descends from, Arnstrom et al. TAC 2022): the dual moves along
    the direction d = sigma * R v (v = working-set rows of G[:, j]), which
    keeps every working-set row tight while growing the candidate's
    multiplier. The step is the smaller of t_primal = violation / gamma
    (gamma = g_jj - v'Rv, the candidate's Schur complement; the full step
    that lands exactly on the enlarged set's minimizer) and t_dual (the
    first working-set multiplier driven to zero). A dual-blocked partial
    step removes the blocking row and KEEPS the candidate pending -- the
    carried ``pend`` index -- so degenerate geometries (gamma ~ 0, routine
    once the set size reaches rank(G) = n << m) resolve by shrinking the
    set until the candidate is supportable, instead of poisoning R with a
    ~1/gamma Woodbury update or cycling between re-picked rows (the m=48
    convergence/accuracy hole). gamma <= tol with no dual blocker and a
    violated candidate is a dual-unbounded ray: primal infeasible
    (``infeas`` flag, engine status -3). Requires a symmetric G_solve.
    """
    dtype = ldp.G.dtype
    m = ldp.G.shape[0]
    idx = jnp.arange(m)
    # finite sentinel: 1e30 dominates every reachable fval/bound in both
    # f32 and f64 and keeps sentinel arithmetic free of inf/NaN
    big = jnp.asarray(min(float(jnp.finfo(dtype).max), 1e30), dtype)
    eps = jnp.finfo(dtype).eps
    # a whisper of ridge only: the GI gamma-guard handles degeneracy
    # structurally, and a large ridge (the masked-Cholesky path's
    # 100*m*eps) would turn dual-unbounded rays of infeasible instances
    # into bounded pseudo-solutions, blinding the infeasibility test
    Gs = ldp.G_solve + (4.0 * eps) * jnp.eye(m, dtype=dtype)

    lam = jnp.where(active, lam, jnp.zeros((), dtype))
    actf0 = active.astype(dtype)
    M0 = Gs * actf0[:, None] * actf0[None, :] + jnp.diag(1.0 - actf0)
    R0 = _masked_inverse(M0)
    PREC = HIGHEST

    def body(s):
        (lam, act, side, it, done, infeas), R, pend, pend_side = s
        pending = pend >= 0
        actf = act.astype(dtype)
        d_side = jnp.where(side, du_t, dl_t)
        rhs = -actf * d_side
        lam_star = jnp.dot(R, rhs, precision=PREC)

        # sign check on the jump target; suspended mid-add (pending mode),
        # where the GI steps maintain dual feasibility by construction
        sign_viol = (~pending) & act & ~is_eq & jnp.where(
            side, lam_star < -sign_tol, lam_star > sign_tol)
        has_viol = jnp.any(sign_viol)

        denom = lam - lam_star
        safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        alpha_i = jnp.where(sign_viol, lam / safe, big)
        jb = jnp.argmin(alpha_i)
        alpha = jnp.clip(alpha_i[jb], 0.0, 1.0)
        lam_B = lam + alpha * (lam_star - lam)
        lam_B = jnp.where(idx == jb, 0.0, lam_B)
        act_B = act & (idx != jb)

        # working point: the jump in normal mode, the carried GI iterate
        # (which holds the pending candidate's partial multiplier) mid-add
        lam_base = jnp.where(pending, lam, jnp.where(act, lam_star, jnp.zeros((), dtype)))
        c = jnp.dot(ldp.G, lam_base, precision=PREC)
        cand = ~act & ~immut
        v_up = jnp.where(cand, -(du_t + c), -big)
        v_lo = jnp.where(cand, dl_t + c, -big)
        v = jnp.maximum(v_up, v_lo)
        j_new = jnp.argmax(v)
        converged = (~pending) & (v[j_new] <= primal_tol)

        j_sel = jnp.where(pending, pend, j_new)
        side_j = jnp.where(pending, pend_side, v_up[j_new] >= v_lo[j_new])
        viol_j = jnp.where(side_j, -(du_t[j_sel] + c[j_sel]), dl_t[j_sel] + c[j_sel])
        # partial steps only reduce the pending violation at rate gamma ~ 0,
        # but if it does drop below tolerance, stop pushing the candidate
        drop_pend = pending & (viol_j <= primal_tol)

        # GI step for candidate j_sel: direction keeps working-set rows
        # tight while growing the candidate's multiplier by sigma * t
        vj = jnp.where(act & (idx != j_sel), Gs[:, j_sel], jnp.zeros((), dtype))
        Rvj = jnp.dot(R, vj, precision=PREC)
        gamma = Gs[j_sel, j_sel] - jnp.dot(vj, Rvj, precision=PREC)
        gamma_tol = jnp.sqrt(eps)
        sgn_j = jnp.where(side_j, 1.0, -1.0).astype(dtype)
        dvec = sgn_j * Rvj
        t_primal = jnp.where(
            gamma > gamma_tol,
            jnp.maximum(viol_j, 0.0) / jnp.maximum(gamma, gamma_tol), big)
        # dual blockers: working-set multipliers driven toward zero
        valid_i = act & ~is_eq & jnp.where(side, dvec > 0.0, dvec < 0.0)
        t_i = jnp.where(valid_i, jnp.maximum(lam_base / jnp.where(dvec == 0.0, 1.0, dvec), 0.0), big)
        ib = jnp.argmin(t_i)
        t_dual = t_i[ib]
        full_add = t_primal <= t_dual
        t_step = jnp.minimum(t_primal, t_dual)
        # no finite step and a violated candidate: dual-unbounded ray
        infeas_now = (~has_viol) & (~converged) & (~drop_pend) & (t_step >= big) & ~done
        take_step = (~has_viol) & (~converged) & (~drop_pend) & (~infeas_now)

        lam_G = jnp.where(act, lam_base - t_step * dvec, lam_base)
        lam_G = jnp.where(idx == j_sel, lam_base[j_sel] + sgn_j * t_step, lam_G)
        lam_G = jnp.where((idx == ib) & ~full_add, 0.0, lam_G)
        act_G = jnp.where(full_add, act | (idx == j_sel), act & (idx != ib))
        side_G = jnp.where(full_add & (idx == j_sel), side_j, side)
        lam_DP = jnp.where(idx == j_sel, 0.0, lam)

        new_lam = jnp.where(has_viol, lam_B,
                   jnp.where(take_step, lam_G,
                    jnp.where(drop_pend, lam_DP, lam_base)))
        new_act = jnp.where(has_viol, act_B, jnp.where(take_step, act_G, act))
        new_side = jnp.where(has_viol | ~take_step, side, side_G)
        new_pend = jnp.where(
            take_step & ~full_add, j_sel.astype(jnp.int32),
            jnp.where(take_step | drop_pend, jnp.int32(-1), pend))
        new_pend = jnp.where(done, pend, new_pend)
        new_pend_side = jnp.where((~done) & take_step, side_j, pend_side)
        new_done = done | (~has_viol & converged) | infeas_now
        changed = (has_viol | take_step) & ~done

        # rank-2 Woodbury update of R for the single changed row ``ch``
        # (a full add of j_sel, a blocking removal of jb, or a partial-step
        # removal of ib)
        is_rem = has_viol | (take_step & ~full_add)
        ch = jnp.where(has_viol, jb, jnp.where(full_add, j_sel, ib))
        vcol = jnp.where(new_act & (idx != ch), Gs[:, ch], jnp.zeros((), dtype))
        gjj = Gs[ch, ch]
        Re = R[:, ch]
        Rv = jnp.dot(R, vcol, precision=PREC)
        a11 = Re[ch]
        a12 = Rv[ch]
        a21 = jnp.dot(vcol, Re, precision=PREC)
        a22 = jnp.dot(vcol, Rv, precision=PREC)
        # capacitance S = C^-1 +/- U'RU with C^-1 = [[0, 1], [1, 1 - gjj]]
        S00 = jnp.where(is_rem, -a11, a11)
        S01 = jnp.where(is_rem, 1.0 - a12, 1.0 + a12)
        S10 = jnp.where(is_rem, 1.0 - a21, 1.0 + a21)
        S11 = jnp.where(is_rem, (1.0 - gjj) - a22, (1.0 - gjj) + a22)
        det = S00 * S11 - S01 * S10
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        # R' = R - sgn_upd * W S^-1 W', W = [Re Rv]; add subtracts, remove adds
        # (M + UCU')^-1 = R - RU S_add^-1 U'R ; (M - UCU')^-1 = R + RU S_rem^-1 U'R
        t0 = (S11 * Re - S10 * Rv) / det     # first column of W S^-1
        t1 = (-S01 * Re + S00 * Rv) / det    # second column
        upd = jnp.outer(t0, Re) + jnp.outer(t1, Rv)
        R_new = jnp.where(is_rem, R + upd, R - upd)
        R = jnp.where(changed, R_new, R)

        lam = jnp.where(done, lam, new_lam)
        act = jnp.where(done, act, new_act)
        side = jnp.where(done, side, new_side)
        return (DualState(lam, act, side, it + jnp.int32(~done), new_done,
                          infeas | infeas_now), R, new_pend, new_pend_side)

    def cond(s):
        st, R, pend, pend_side = s
        return (~st.done) & (st.iters < max_iter)

    it0 = jnp.int32(0) if iters0 is None else iters0
    init = (DualState(lam, active, side, it0, jnp.asarray(False),
                      jnp.asarray(False)), R0, jnp.int32(-1), jnp.asarray(True))
    final, R, _pend, _ps = jax.lax.while_loop(cond, body, init)
    return (final, R) if return_R else final


def _transformed_bounds(ldp: LDPArrays, theta, forced_mask, forced_side):
    # HIGHEST: a reduced-precision f32 product (TF32/bf16) would put
    # ~1e-3 noise on the bounds against a 2e-5 primal tolerance
    P = HIGHEST
    du_t = ldp.du + jnp.dot(ldp.Dth, theta, precision=P)
    dl_t = ldp.dl + jnp.dot(ldp.Dth, theta, precision=P)
    if forced_mask is not None:
        d_forced = jnp.where(forced_side, du_t, dl_t)
        du_t = jnp.where(forced_mask, d_forced, du_t)
        dl_t = jnp.where(forced_mask, d_forced, dl_t)
    return du_t, dl_t


def solve_single(
    ldp: LDPArrays,
    theta: jax.Array,
    lam0: jax.Array | None = None,
    active0: jax.Array | None = None,
    side0: jax.Array | None = None,
    *,
    max_iter: int = 500,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-12,
    forced_side: jax.Array | None = None,
    forced_mask: jax.Array | None = None,
    use_cholesky: bool = True,
    ldp_hi: "LDPArrays | None" = None,
    refine_iter: int = 16,
    bulk_iter_cap: int | None = None,
    bulk_unroll: int = 0,
    bulk_inverse_updates: bool = False,
) -> Solution:
    """Solve one LDP instance parameterized by ``theta``.

    ``forced_mask``/``forced_side`` clamp the given rows to equality at the
    chosen bound -- the mechanism branch-and-bound uses to fix binary
    constraints per node (reference: DAQP bnb, SURVEY.md N2).

    ``ldp_hi``: optional high-precision (float64) copy of the solver arrays.
    When given, the low-precision iteration is continued in that precision
    (warm-started, a handful of steps) and the final working set re-solved
    exactly -- so the float32 bulk path still returns float64-accurate
    solutions, the accelerator replacement for DAQP's all-double arithmetic.

    Wrap with ``jax.vmap`` over ``theta`` (and warm-start state) for batches.
    """
    dtype = ldp.G.dtype
    m = ldp.G.shape[0]
    # keep the caller's theta for the high-precision phase; truncate only
    # for the bulk iteration (an early downcast would bake f32 rounding of
    # theta into the polished answer)
    theta_lo = theta.astype(dtype)

    if m == 0:  # unconstrained: closed-form minimizer
        src = ldp if ldp_hi is None else ldp_hi
        th = theta.astype(src.G.dtype)
        U = src.u_off + jnp.dot(src.Uth_off, th, precision=HIGHEST)
        f_t = src.f + jnp.dot(src.f_theta, th, precision=HIGHEST)
        fval = (0.5 * jnp.dot(U, jnp.dot(src.H, U, precision=HIGHEST), precision=HIGHEST)
                + jnp.dot(f_t, U, precision=HIGHEST))
        z = jnp.zeros(0, dtype=dtype)
        zb = jnp.zeros(0, dtype=bool)
        return Solution(U, z, zb, zb, fval, jnp.int32(0), jnp.int32(1))

    is_eq = ldp.is_eq
    immut = ldp.is_immutable
    if forced_mask is not None:
        is_eq = is_eq | forced_mask
    du_t, dl_t = _transformed_bounds(ldp, theta_lo, forced_mask, forced_side)

    lam = jnp.zeros(m, dtype=dtype) if lam0 is None else lam0.astype(dtype)
    active = is_eq if active0 is None else (active0 | is_eq)
    side = jnp.ones(m, dtype=bool) if side0 is None else side0
    lam = jnp.where(active, lam, 0.0)

    # the bulk phase gets a small budget when a high-precision phase
    # follows: a rare f32 tolerance cycle must not stall the whole lockstep
    # batch -- the f64 continuation finishes any straggler exactly
    if ldp_hi is not None:
        cap = bulk_iter_cap if bulk_iter_cap is not None else 2 * m + 16
        max_iter_lo = min(max_iter, cap)
    else:
        max_iter_lo = max_iter
    if bulk_inverse_updates and ldp.subset_inv is None:
        # O(m^2) recursive Woodbury updates for the bulk phase (m beyond
        # the subset cache); the high-precision continuation below keeps
        # exact masked factorizations
        final = _active_set_loop_iu(
            ldp, du_t, dl_t, is_eq, immut, lam, active, side,
            max_iter=max_iter_lo, primal_tol=primal_tol, sign_tol=sign_tol,
        )
    else:
        final = _active_set_loop(
            ldp, du_t, dl_t, is_eq, immut, lam, active, side,
            max_iter=max_iter_lo, primal_tol=primal_tol, sign_tol=sign_tol,
            use_cholesky=use_cholesky, unroll=bulk_unroll if ldp_hi is not None else 0,
        )

    if ldp_hi is not None:
        # continue the iteration in high precision from the bulk result:
        # corrects marginal working-set choices, then the final masked solve
        # is exact in float64
        hi = ldp_hi.G.dtype
        theta_hi = theta.astype(hi)
        du_hi, dl_hi = _transformed_bounds(ldp_hi, theta_hi, forced_mask, forced_side)
        final = _active_set_loop(
            ldp_hi, du_hi, dl_hi, is_eq, immut,
            final.lam.astype(hi), final.active, final.side,
            max_iter=max_iter + refine_iter,
            primal_tol=min(primal_tol, 1e-6), sign_tol=1e-11,
            use_cholesky=use_cholesky, iters0=final.iters,
        )
        U = ldp_hi.u_off + ldp_hi.Uth_off @ theta_hi - ldp_hi.HinvET @ final.lam
        f_t = ldp_hi.f + ldp_hi.f_theta @ theta_hi
        fval = 0.5 * U @ (ldp_hi.H @ U) + f_t @ U
        # full-row primal check, ACTIVE rows included: on a primal-
        # infeasible instance every violated row can end up active, where
        # the loop's candidate test (inactive rows only) never sees it --
        # the ridge then converges to a pseudo-solution with huge
        # multipliers and status 1 (observed: diverged rollouts at
        # |x| ~ 1e4 reported "converged")
        feas = _primal_feasible(ldp_hi, du_hi, dl_hi, final.lam,
                                final.active, final.side, primal_tol)
        status = jnp.where(final.done & feas, jnp.int32(1),
                           jnp.where(final.done, jnp.int32(-3), jnp.int32(-1)))
        return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)

    U = (ldp.u_off + jnp.dot(ldp.Uth_off, theta_lo, precision=HIGHEST)
         - jnp.dot(ldp.HinvET, final.lam, precision=HIGHEST))
    f_t = ldp.f + jnp.dot(ldp.f_theta, theta_lo, precision=HIGHEST)
    fval = (0.5 * jnp.dot(U, jnp.dot(ldp.H, U, precision=HIGHEST), precision=HIGHEST)
            + jnp.dot(f_t, U, precision=HIGHEST))
    feas = _primal_feasible(ldp, du_t, dl_t, final.lam,
                            final.active, final.side, primal_tol)
    status = jnp.where(final.infeas | (final.done & ~feas), jnp.int32(-3),
                       jnp.where(final.done, jnp.int32(1), jnp.int32(-1)))
    return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)


def _primal_feasible(ldp: LDPArrays, du_t, dl_t, lam, act, side, primal_tol):
    """Sound converged-point check covering ACTIVE rows, which the loop's
    candidate test (inactive rows only) never sees: on a primal-infeasible
    instance every violated row can end up active, where the Cholesky
    ridge converges to a pseudo-solution with huge multipliers -- its
    working-set KKT residual (G_solve lam + d_side on active rows, soft
    diagonal included so legitimately-violated soft rows pass) is then
    O(ridge * |lam|) = O(violation), not ~0. Inactive rows use the loop's
    own candidate test."""
    P = HIGHEST
    actf = act.astype(lam.dtype)
    d_side = jnp.where(side, du_t, dl_t)
    res_act = (actf * jnp.dot(ldp.G_solve, lam * actf, precision=P)
               + actf * d_side)
    scale = 1.0 + jnp.max(jnp.abs(actf * d_side))
    c = jnp.dot(ldp.G, lam, precision=P)
    inact = ~act & ~ldp.is_immutable
    viol_in = jnp.max(jnp.where(inact, jnp.maximum(-(du_t + c), dl_t + c), 0.0))
    return (jnp.max(jnp.abs(res_act)) <= 10.0 * primal_tol * scale) \
        & (viol_in <= 10.0 * primal_tol * (1.0 + jnp.max(jnp.abs(c))))


def finish_from_state(
    ldp_hi: LDPArrays,
    theta: jax.Array,
    lam: jax.Array,
    active: jax.Array,
    side: jax.Array,
    iters0: jax.Array,
    *,
    max_iter: int = 32,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-11,
    use_cholesky: bool = True,
) -> Solution:
    """High-precision continuation + primal recovery from a bulk-phase state
    (the tail of ``solve_single`` as a standalone entry, used after the
    fused bulk kernel)."""
    hi = ldp_hi.G.dtype
    theta_hi = theta.astype(hi)
    du_hi, dl_hi = _transformed_bounds(ldp_hi, theta_hi, None, None)
    final = _active_set_loop(
        ldp_hi, du_hi, dl_hi, ldp_hi.is_eq, ldp_hi.is_immutable,
        lam.astype(hi), active | ldp_hi.is_eq, side,
        max_iter=max_iter + iters0.astype(jnp.int32), primal_tol=primal_tol,
        sign_tol=sign_tol, use_cholesky=use_cholesky, iters0=iters0.astype(jnp.int32),
    )
    U = ldp_hi.u_off + ldp_hi.Uth_off @ theta_hi - ldp_hi.HinvET @ final.lam
    f_t = ldp_hi.f + ldp_hi.f_theta @ theta_hi
    fval = 0.5 * U @ (ldp_hi.H @ U) + f_t @ U
    status = jnp.where(final.done, jnp.int32(1), jnp.int32(-1))
    return Solution(U, final.lam, final.active, final.side, fval, final.iters, status)


def polish_solution(
    ldp_hi: LDPArrays,
    theta: jax.Array,
    active: jax.Array,
    side: jax.Array,
    *,
    use_cholesky: bool = True,
    iters=None,
    status=None,
) -> Solution:
    """Direct high-precision re-solve of a known optimal active set
    (used to polish branch-and-bound incumbents). All matvecs run at
    HIGHEST precision: when ``ldp_hi`` is float32 (x64 disabled) a default
    f32 product may run at reduced precision."""
    PH = HIGHEST
    hi = ldp_hi.G.dtype
    theta_hi = theta.astype(hi)
    du_hi = ldp_hi.du + jnp.dot(ldp_hi.Dth, theta_hi, precision=PH)
    dl_hi = ldp_hi.dl + jnp.dot(ldp_hi.Dth, theta_hi, precision=PH)
    actf = active.astype(hi)
    d_side = jnp.where(side, du_hi, dl_hi)
    rhs_hi = -actf * d_side
    if ldp_hi.subset_inv is not None:
        m = ldp_hi.G.shape[0]
        pow2 = jnp.asarray(2 ** np.arange(m), dtype=jnp.int32)
        lam = jnp.dot(ldp_hi.subset_inv[jnp.sum(jnp.where(active, pow2, 0))],
                      rhs_hi, precision=PH)
    else:
        Gmask = ldp_hi.G_solve * actf[:, None] * actf[None, :] + jnp.diag(1.0 - actf)
        lam = _masked_solve(Gmask, rhs_hi, use_cholesky)
    U = (ldp_hi.u_off + jnp.dot(ldp_hi.Uth_off, theta_hi, precision=PH)
         - jnp.dot(ldp_hi.HinvET, lam, precision=PH))
    f_t = ldp_hi.f + jnp.dot(ldp_hi.f_theta, theta_hi, precision=PH)
    fval = 0.5 * jnp.dot(U, jnp.dot(ldp_hi.H, U, precision=PH), precision=PH) \
        + jnp.dot(f_t, U, precision=PH)
    iters = jnp.int32(0) if iters is None else iters
    status = jnp.int32(1) if status is None else status
    return Solution(U, lam, active, side, fval, iters, status)


def solve_batch(
    ldp: LDPArrays,
    thetas: jax.Array,
    lam0: jax.Array | None = None,
    active0: jax.Array | None = None,
    side0: jax.Array | None = None,
    **kw,
) -> Solution:
    """vmap of ``solve_single`` over a (B, n_theta) parameter batch, with
    optional per-lane warm starts."""
    if lam0 is None:
        fn = lambda th: solve_single(ldp, th, **kw)
        return jax.vmap(fn)(thetas)
    fn = lambda th, l0, a0, s0: solve_single(ldp, th, l0, a0, s0, **kw)
    return jax.vmap(fn)(thetas, lam0, active0, side0)
