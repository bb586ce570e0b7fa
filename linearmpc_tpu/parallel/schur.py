"""Distributed (mp-sharded) dual active-set solving for large-m problems.

The single-chip solver factorizes the masked working-set KKT system
M = act G_solve act' + diag(1-act) per iteration (ops/dual_active_set.py).
For condensed problems with thousands of constraint rows (long horizons
with dense stage constraints) one chip's O(m^2) rows or O(m^3) factor can
be the limit, and the reference has no answer at all (single C solve,
SURVEY.md section 2.3). Here the constraint-row dimension is sharded over
the ``mp`` mesh axis and the scenario batch over ``dp``, with explicit
``shard_map`` collectives (all_gather over the device interconnect) instead of GSPMD guessing:

* every device holds the full per-lane iteration state (lam, act, side)
  for its ``dp`` shard of lanes, but only an (m/mp, m) row block of the
  dual Gram matrix;
* the masked KKT solve is conjugate gradients on the SPD masked system --
  the one operation that touches G -- with the matvec computed as a local
  row-block product followed by a tiled ``all_gather`` over ``mp``.
  Row normalization (ops/ldp.py) gives M a unit diagonal, so plain CG
  converges fast without a preconditioner;
* blocking/acceptance steps are elementwise per lane and run replicated.

This is the batched analog of a distributed Schur/block elimination:
the per-shard row blocks are the Schur blocks, and the reduction over
shards happens inside every CG matvec rather than in a serial block-LU
chain (which would idle mp-1 shards at a time).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dual_active_set import Solution
from ..ops.ldp import LDPData


def _pad_rows(a, m_pad):
    """Pad the row (constraint) dimension of a host array to m_pad."""
    a = np.asarray(a, dtype=np.float64)
    if a.shape[0] == m_pad:
        return a
    pad = [(0, m_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def make_mp_batch_solver(
    ldp: LDPData,
    mesh: Mesh,
    *,
    max_iter: int = 200,
    cg_iter: int | None = None,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-9,
    dtype=jnp.float64,
    ridge: float = 1e-6,
    polish_steps: int | None = None,
    polish_ridge: float | None = None,
):
    """Compile a (dp, mp)-sharded batched LDP solver for ``ldp``.

    Returns ``solve(thetas) -> Solution`` where ``thetas`` is (B, n_theta)
    with B divisible by the ``dp`` axis size. Constraint rows are padded to
    a multiple of ``mp`` and marked immutable, which leaves the solution
    unchanged (padded rows have infinite bounds and zero coupling).
    """
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    m_true = ldp.m
    m = ((m_true + mp - 1) // mp) * mp
    n = ldp.n
    cg_iter = cg_iter if cg_iter is not None else min(m, 64)

    # host-side padding of the row dimension (padded rows: immutable,
    # infinite bounds, identity diagonal in G_solve so the masked system
    # stays SPD)
    Gs = np.zeros((m, m))
    Gs[:m_true, :m_true] = ldp.G + np.diag(np.asarray(ldp.rho_soft, dtype=np.float64))
    Gs[range(m_true, m), range(m_true, m)] = 1.0
    # ridge on the masked system (rows are G-normalized to unit diagonal,
    # so this bounds its condition number near 1/ridge): CG against the
    # UNRIDGED system on massively degenerate working sets need not reach
    # the exit tolerance, and the walk then cycles. The final KKT
    # verification keeps the TRUE primal slacks.
    Gs[range(m), range(m)] += ridge
    G_plain = np.zeros((m, m))
    G_plain[:m_true, :m_true] = ldp.G

    du = _pad_rows(ldp.du, m)
    dl = _pad_rows(ldp.dl, m)
    du[m_true:] = 1e30
    dl[m_true:] = -1e30
    Dth = _pad_rows(ldp.Dth, m)
    HinvET = np.zeros((n, m))
    HinvET[:, :m_true] = ldp.HinvET
    is_eq = np.zeros(m, bool)
    is_eq[:m_true] = ldp.is_eq
    immut = np.ones(m, bool)
    immut[:m_true] = ldp.is_immutable

    cast = lambda a: jnp.asarray(a, dtype)
    consts = dict(
        du=cast(du), dl=cast(dl), Dth=cast(Dth),
        HinvET=cast(HinvET), Uth_off=cast(ldp.Uth_off), u_off=cast(ldp.u_off),
        H=cast(ldp.H), f=cast(ldp.f), f_theta=cast(ldp.f_theta),
        is_eq=jnp.asarray(is_eq), immut=jnp.asarray(immut),
    )
    # row-sharded Gram blocks: (m, m) split along rows over mp. A
    # NEAR-UNRIDGED copy is kept alongside: the working-set walk iterates
    # the robustly ridged system (conditioning), then a Richardson polish
    # against this polish target -- each correction solved on the walk
    # system -- restores accuracy. A strictly positive ``polish_ridge``
    # bounds the spectral radius of the Richardson iteration matrix
    # I - M_walk^-1 M_polish by 1 - rp/ridge < 1 on EVERY eigenspace,
    # including the masked system's null space (null-space multiplier
    # components never affect U: null(G_mask) vectors v have E'v = 0
    # exactly, since v'Gv = ||H^-1/2 E'v||^2). With native f64 the target
    # ridge is 0 and this is the exact polish.
    if polish_ridge is None:
        polish_ridge = 0.0
    if polish_steps is None:
        polish_steps = 4
    Gs_true = Gs.copy()
    Gs_true[range(m), range(m)] -= ridge - polish_ridge
    Gs_sh = jax.device_put(cast(Gs), NamedSharding(mesh, P("mp", None)))
    Gst_sh = jax.device_put(cast(Gs_true), NamedSharding(mesh, P("mp", None)))
    Gp_sh = jax.device_put(cast(G_plain), NamedSharding(mesh, P("mp", None)))
    # finite sentinel: keeps sentinel arithmetic free of inf/NaN (see
    # ops/dual_active_set.py)
    big = jnp.asarray(1e30, dtype)

    def mp_matvec(G_local, x, act=None):
        """y = M x with M = act G act' + diag(1-act) (or plain G when
        ``act`` is None). ``x`` (b, m) replicated over mp; G_local the
        local (m/mp, m) row block; tiled all_gather restores (b, m)."""
        xin = x if act is None else act * x
        part = xin @ G_local.T                      # (b, m/mp) local rows
        y = jax.lax.all_gather(part, "mp", axis=1, tiled=True)  # (b, m)
        if act is None:
            return y
        return act * y + (1.0 - act) * x

    # CG exits on the residual dropping well below the solver's sign/
    # primal tolerances (not only on the iteration budget): an
    # under-converged lam_star would silently corrupt the working-set
    # logic on ill-conditioned active sets. The tolerance is per lane
    # and RELATIVE to ||rhs|| with an absolute floor: a fixed absolute
    # target can sit below the achievable residual floor, and every CG
    # would burn its full budget without converging. The relative target
    # must sit ABOVE the CG residual floor eps * cond(M_ridged): with the
    # 1e-6 ridge and unit-diagonal rows, cond <= 1e6
    cg_abs2 = jnp.asarray(min(sign_tol, primal_tol) ** 2 * 1e-4, dtype)
    cg_rel = jnp.asarray(1e-7, dtype)

    def cg_solve(G_local, act, rhs, x0):
        """Batched CG on the masked SPD system (unit diagonal + ridge);
        warm started from the current multipliers (close to lam_star
        after the first few working-set changes). Runs until every
        lane's residual norm-squared is below its tolerance or the
        iteration budget is hit.

        The system is NORMALIZED per lane by ||rhs|| before iterating:
        on ill-conditioned masked systems the raw CG iterates (p, q, rr)
        can grow without bound and poison whole lanes with NaN
        multipliers; with a unit-norm right-hand side every intermediate
        stays within ~cond(M) of unity."""
        rn = jnp.sqrt(jnp.sum(rhs * rhs, axis=-1, keepdims=True))
        scale = jnp.maximum(rn, 1e-30)
        rhs_n = rhs / scale
        x = x0 / scale
        r = rhs_n - mp_matvec(G_local, x, act)
        p = r
        rr = jnp.sum(r * r, axis=-1, keepdims=True)
        tol2 = jnp.maximum(cg_abs2 / (scale * scale), (cg_rel ** 2))

        def body(state):
            x, r, p, rr, i = state
            q = mp_matvec(G_local, p, act)
            pq = jnp.sum(p * q, axis=-1, keepdims=True)
            alpha = jnp.where(pq > 0, rr / jnp.maximum(pq, 1e-300), 0.0)
            x = x + alpha * p
            r = r - alpha * q
            rr_new = jnp.sum(r * r, axis=-1, keepdims=True)
            beta = rr_new / jnp.maximum(rr, 1e-300)
            p = r + beta * p
            return x, r, p, rr_new, i + 1

        def cond(state):
            _x, _r, _p, rr, i = state
            return (i < cg_iter) & jnp.any(rr > tol2)

        x, r, p, rr, _ = jax.lax.while_loop(
            cond, body, (x, r, p, rr, jnp.int32(0))
        )
        return x * scale

    def solver_block(G_local, Gt_local, Gp_local, thetas):
        """Runs per (dp, mp) device block under shard_map; thetas is the
        local (b, n_theta) lane shard (replicated over mp)."""
        b = thetas.shape[0]
        du_t = consts["du"] + thetas @ consts["Dth"].T
        dl_t = consts["dl"] + thetas @ consts["Dth"].T
        is_eq = consts["is_eq"]
        immut = consts["immut"]

        lam0 = jnp.zeros((b, m), dtype)
        act0 = jnp.broadcast_to(is_eq, (b, m))
        side0 = jnp.ones((b, m), bool)
        done0 = jnp.zeros(b, bool)
        it0 = jnp.zeros(b, jnp.int32)

        def body(state):
            lam, act, side, done, iters = state
            actf = act.astype(dtype)
            d_side = jnp.where(side, du_t, dl_t)
            rhs = -actf * d_side
            lam_star = cg_solve(G_local, actf, rhs, actf * lam)

            sign_viol = act & ~is_eq & jnp.where(
                side, lam_star < -sign_tol, lam_star > sign_tol
            )
            has_viol = jnp.any(sign_viol, axis=-1, keepdims=True)

            denom = lam - lam_star
            safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
            alpha_i = jnp.where(sign_viol, lam / safe, big)
            alpha_min = jnp.min(alpha_i, axis=-1, keepdims=True)
            csum = jnp.cumsum((alpha_i <= alpha_min).astype(dtype), axis=-1)
            is_jb = (alpha_i <= alpha_min) & (csum <= 1.0)
            alpha = jnp.clip(alpha_min, 0.0, 1.0)
            lam_B = jnp.where(is_jb, 0.0, lam + alpha * (lam_star - lam))
            act_B = act & ~is_jb

            c = mp_matvec(Gp_local, lam_star)
            cand = ~act & ~immut
            v_up = jnp.where(cand, -(du_t + c), -big)
            v_lo = jnp.where(cand, dl_t + c, -big)
            v = jnp.maximum(v_up, v_lo)
            vmax = jnp.max(v, axis=-1, keepdims=True)
            conv = vmax <= primal_tol
            csum2 = jnp.cumsum((v >= vmax).astype(dtype), axis=-1)
            is_j = (v >= vmax) & (csum2 <= 1.0)
            grow = is_j & ~conv
            act_A = act | grow
            side_A = jnp.where(grow, v_up >= v_lo, side)
            lam_A = jnp.where(act_A, lam_star, 0.0)

            new_lam = jnp.where(has_viol, lam_B, lam_A)
            new_act = jnp.where(has_viol, act_B, act_A)
            new_side = jnp.where(has_viol, side, side_A)
            new_done = done | (~has_viol[:, 0] & conv[:, 0])

            keep = done[:, None]
            lam = jnp.where(keep, lam, new_lam)
            act = jnp.where(keep, act, new_act)
            side = jnp.where(keep, side, new_side)
            return lam, act, side, new_done, iters + (~done).astype(jnp.int32)

        def cond(state):
            lam, act, side, done, iters = state
            return (~jnp.all(done)) & (jnp.max(iters) < max_iter)

        lam, act, side, done, iters = jax.lax.while_loop(
            cond, body, (lam0, act0, side0, done0, it0)
        )

        # final polish: ridged-CG-preconditioned Richardson on the TRUE
        # system's residual. Plain CG on the unridged masked system
        # cannot converge on degenerate working sets (condition number
        # unbounded; measured 0% convergence on-chip); Richardson with
        # the ridged solve contracts the range-space error by
        # ~ridge/lambda per pass, and the null-space components it
        # cannot fix do not affect U at all (null(G_mask) vectors v have
        # E'v = 0 exactly, since v'Gv = ||H^-1/2 E'v||^2).
        actf_p = act.astype(dtype)
        rhs_p = -actf_p * jnp.where(side, du_t, dl_t)
        lam = actf_p * lam
        for _ in range(polish_steps):
            res_p = rhs_p - mp_matvec(Gt_local, lam, actf_p)
            lam = lam + cg_solve(G_local, actf_p, res_p,
                                 jnp.zeros_like(lam))

        # primal recovery (replicated small matvecs)
        U = consts["u_off"] + thetas @ consts["Uth_off"].T - lam @ consts["HinvET"].T
        f_t = consts["f"] + thetas @ consts["f_theta"].T
        fval = 0.5 * jnp.einsum("bi,ij,bj->b", U, consts["H"], U) + jnp.sum(f_t * U, axis=-1)
        # post-hoc KKT verification (mirrors engine._iu_batch's ``bad``
        # check): ``done`` certifies the active-set loop's own tests, which
        # rest on CG solves -- verify the full residual before reporting
        # optimality so an under-converged CG lane cannot claim status 1
        actf = act.astype(dtype)
        d_side = jnp.where(side, du_t, dl_t)
        kkt_res = jnp.max(
            jnp.abs(mp_matvec(Gt_local, lam, actf) - (-actf * d_side)), axis=-1
        )
        c = mp_matvec(Gp_local, lam)
        inact = ~act & ~immut
        primal = jnp.max(jnp.where(inact, jnp.maximum(-(du_t + c), dl_t + c), -big),
                         axis=-1)
        sgn = jnp.max(jnp.where(act & ~is_eq, jnp.where(side, -lam, lam), -big),
                      axis=-1)
        bad = jnp.maximum(jnp.maximum(primal, sgn), kkt_res)
        ok = done & (bad <= 10.0 * primal_tol)
        status = jnp.where(ok, jnp.int32(1), jnp.int32(-1))
        return U, lam[:, :m_true], act[:, :m_true], side[:, :m_true], fval, iters, status

    from jax import shard_map

    sharded = shard_map(
        solver_block, mesh=mesh,
        in_specs=(P("mp", None), P("mp", None), P("mp", None), P("dp", None)),
        out_specs=(P("dp", None),) * 4 + (P("dp"),) * 3,
        check_vma=False,
    )
    jitted = jax.jit(lambda th: sharded(Gs_sh, Gst_sh, Gp_sh, th))
    theta_sharding = NamedSharding(mesh, P("dp", None))

    def solve(thetas) -> Solution:
        thetas = jax.device_put(jnp.asarray(thetas, dtype), theta_sharding)
        U, lam, act, side, fval, iters, status = jitted(thetas)
        return Solution(U, lam, act, side, fval, iters, status)

    return solve
