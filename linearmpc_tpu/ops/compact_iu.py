"""Compact working-set dual active-set solver for large m.

The full inverse-update loop (ops/dual_active_set._active_set_loop_iu)
carries the (m, m) masked working-set inverse per lane, which makes
every iteration stream O(m^2) per lane -- the regime where realistic MPC with state
constraints lives (m = 100..500+).

DAQP never materializes an (m, m) object: its recursive LDL' factors the
ACTIVE rows only (Arnstrom, Bemporad, Axehill, IEEE TAC 2022; reference
README.md:70-82). This module is the lockstep-batched analog: each lane
carries a fixed-capacity compact inverse

    Rw = inv(M_w),  M_w[k, l] = G_solve[slots[k], slots[l]]  (occupied k, l)

over ``s_max`` working-set SLOTS (identity rows on unoccupied slots),
plus the slot bookkeeping (``slots`` row indices, ``occ`` mask). The
iteration is the same Goldfarb-Idnani scheme as the full loop -- pending
partial-step candidates, dual-unbounded-ray infeasibility detection,
rank-2 Woodbury updates -- with every working-set operation performed in
slot space through gathers/scatters, which XLA handles natively. Memory and per-iteration work drop from
O(m^2) to O(s_max^2 + m) per lane, so m = 256+ problems run at full
batch sizes where the active set stays small (s_max <= n + a few soft
rows generically).

A lane whose working set outgrows ``s_max`` raises its ``overflow`` flag
and stops; the engine routes such lanes through the full-matrix f64
straggler tier.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .dual_active_set import DualState, LDPArrays, _masked_inverse


class CompactCarry(NamedTuple):
    Rw: jax.Array     # (s, s) compact working-set inverse
    slots: jax.Array  # (s,) int32 row index per slot (garbage when ~occ)
    occ: jax.Array    # (s,) bool slot occupied


def init_compact(Gs: jax.Array, act0: jax.Array, s_max: int) -> CompactCarry:
    """Slot assignment + compact inverse for an initial active set (one
    lane). Overflowing rows beyond ``s_max`` are dropped from the carry
    (the caller checks ``sum(act0) <= s_max`` and flags overflow)."""
    m = Gs.shape[0]
    order = jnp.argsort(~act0)  # active rows first, stable
    slots = order[:s_max].astype(jnp.int32)
    occ = act0[slots]
    Mw = Gs[slots][:, slots]
    occf = occ.astype(Gs.dtype)
    Mw = Mw * occf[:, None] * occf[None, :] + jnp.diag(1.0 - occf)
    Rw = _masked_inverse(Mw)
    return CompactCarry(Rw, slots, occ)


def _active_set_loop_ciu(
    ldp: LDPArrays,
    du_t, dl_t, is_eq, immut,
    lam, active, side,
    *,
    s_max: int,
    max_iter: int,
    primal_tol: float,
    sign_tol: float,
    iters0=None,
    return_carry: bool = False,
    carry0: CompactCarry | None = None,
):
    """One-lane compact GI iteration (wrap in ``jax.vmap`` for batches).

    Mirrors ``_active_set_loop_iu`` exactly (same candidate/pending/
    infeasibility semantics, differential-tested against it) with the
    carried inverse restricted to the working-set slots. Returns
    ``(DualState, overflow)`` -- plus the compact carry with
    ``return_carry`` for use by finishing tiers.
    """
    dtype = ldp.G.dtype
    m = ldp.G.shape[0]
    idx = jnp.arange(m)
    sidx = jnp.arange(s_max)
    # finite sentinel: 1e30 dominates every reachable fval/bound in both
    # f32 and f64 and keeps sentinel arithmetic free of inf/NaN
    big = jnp.asarray(min(float(jnp.finfo(dtype).max), 1e30), dtype)
    eps = jnp.finfo(dtype).eps
    Gs = ldp.G_solve + (4.0 * eps) * jnp.eye(m, dtype=dtype)

    lam = jnp.where(active, lam, jnp.zeros((), dtype))
    carry = init_compact(Gs, active, s_max) if carry0 is None else carry0
    overflow0 = jnp.sum(active) > s_max

    PREC = jax.lax.Precision.HIGHEST

    def scatter(vals_w, slots, occ):
        """Slot-space (s,) -> row-space (m,), zeros elsewhere."""
        return jnp.zeros(m, dtype).at[slots].add(
            jnp.where(occ, vals_w, jnp.zeros((), dtype)))

    def body(s):
        (lam, act, side, it, done, infeas), cc, pend, pend_side, ovf = s
        Rw, slots, occ = cc
        occf = occ.astype(dtype)
        pending = pend >= 0
        actf = act.astype(dtype)
        d_side = jnp.where(side, du_t, dl_t)
        rhs_full = -actf * d_side
        rhs_w = rhs_full[slots] * occf
        lam_star_w = jnp.dot(Rw, rhs_w, precision=PREC)
        lam_star = scatter(lam_star_w, slots, occ)

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
        drop_pend = pending & (viol_j <= primal_tol)

        # GI add step in slot space
        Gcol = Gs[j_sel, :]  # symmetric: column j_sel
        vj_w = Gcol[slots] * occf * (slots != j_sel)
        Rvj_w = jnp.dot(Rw, vj_w, precision=PREC)
        gamma = Gs[j_sel, j_sel] - jnp.dot(vj_w, Rvj_w, precision=PREC)
        gamma_tol = jnp.sqrt(eps)
        sgn_j = jnp.where(side_j, 1.0, -1.0).astype(dtype)
        dvec_w = sgn_j * Rvj_w
        t_primal = jnp.where(
            gamma > gamma_tol,
            jnp.maximum(viol_j, 0.0) / jnp.maximum(gamma, gamma_tol), big)
        lam_w = lam_base[slots]
        side_w = side[slots]
        eq_w = is_eq[slots]
        valid_w = occ & ~eq_w & jnp.where(side_w, dvec_w > 0.0, dvec_w < 0.0)
        t_i = jnp.where(valid_w,
                        jnp.maximum(lam_w / jnp.where(dvec_w == 0.0, 1.0, dvec_w), 0.0),
                        big)
        ib_slot = jnp.argmin(t_i)
        t_dual = t_i[ib_slot]
        ib_row = slots[ib_slot]
        full_add = t_primal <= t_dual
        t_step = jnp.minimum(t_primal, t_dual)
        infeas_now = (~has_viol) & (~converged) & (~drop_pend) & (t_step >= big) & ~done
        # a full add with no free slot: working set exceeds capacity
        free_avail = ~jnp.all(occ)
        overflow_now = (~has_viol) & (~converged) & (~drop_pend) & (~infeas_now) \
            & full_add & ~free_avail & ~done
        take_step = (~has_viol) & (~converged) & (~drop_pend) & (~infeas_now) \
            & (~overflow_now)

        dvec = scatter(dvec_w, slots, occ)
        lam_G = jnp.where(act, lam_base - t_step * dvec, lam_base)
        lam_G = jnp.where(idx == j_sel, lam_base[j_sel] + sgn_j * t_step, lam_G)
        lam_G = jnp.where((idx == ib_row) & ~full_add, 0.0, lam_G)
        act_G = jnp.where(full_add, act | (idx == j_sel), act & (idx != ib_row))
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
        new_done = done | (~has_viol & converged) | infeas_now | overflow_now
        changed = (has_viol | take_step) & ~done

        # slot of the changed row: removal targets the slot holding the
        # row; an add claims the first free slot
        is_rem = has_viol | (take_step & ~full_add)
        ch_row = jnp.where(has_viol, jb, jnp.where(full_add, j_sel, ib_row)).astype(jnp.int32)
        rem_slot = jnp.argmax((slots == ch_row) & occ)
        free_slot = jnp.argmin(occ)  # first unoccupied
        slot_ch = jnp.where(is_rem, rem_slot, free_slot)

        # slot bookkeeping for an add BEFORE the Woodbury pieces, so the
        # new row's Gram column is gathered against the updated slots
        adding = changed & ~is_rem
        slots_n = jnp.where(adding & (sidx == slot_ch), ch_row, slots)
        occ_n = jnp.where(changed & (sidx == slot_ch), ~is_rem, occ)

        # rank-2 Woodbury update of Rw at slot_ch (same capacitance
        # algebra as the full-space loop, restricted to slot space)
        Gch = Gs[ch_row, :]
        occf_n = occ_n.astype(dtype)
        vcol_w = Gch[slots_n] * occf_n * (sidx != slot_ch)
        gjj = Gs[ch_row, ch_row]
        Re = Rw[:, slot_ch]
        Rv = jnp.dot(Rw, vcol_w, precision=PREC)
        a11 = Re[slot_ch]
        a12 = Rv[slot_ch]
        a21 = jnp.dot(vcol_w, Re, precision=PREC)
        a22 = jnp.dot(vcol_w, Rv, precision=PREC)
        S00 = jnp.where(is_rem, -a11, a11)
        S01 = jnp.where(is_rem, 1.0 - a12, 1.0 + a12)
        S10 = jnp.where(is_rem, 1.0 - a21, 1.0 + a21)
        S11 = jnp.where(is_rem, (1.0 - gjj) - a22, (1.0 - gjj) + a22)
        det = S00 * S11 - S01 * S10
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        t0 = (S11 * Re - S10 * Rv) / det
        t1 = (-S01 * Re + S00 * Rv) / det
        upd = jnp.outer(t0, Re) + jnp.outer(t1, Rv)
        Rw_new = jnp.where(is_rem, Rw + upd, Rw - upd)
        Rw = jnp.where(changed, Rw_new, Rw)
        slots = jnp.where(changed, slots_n, slots)
        occ = jnp.where(changed, occ_n, occ)

        lam = jnp.where(done, lam, new_lam)
        act = jnp.where(done, act, new_act)
        side = jnp.where(done, side, new_side)
        return (DualState(lam, act, side, it + jnp.int32(~done), new_done,
                          infeas | infeas_now),
                CompactCarry(Rw, slots, occ), new_pend, new_pend_side,
                ovf | overflow_now)

    def cond(s):
        st, _cc, _p, _ps, _o = s
        return (~st.done) & (st.iters < max_iter)

    it0 = jnp.int32(0) if iters0 is None else iters0
    init = (DualState(lam, active, side, it0, overflow0, jnp.asarray(False)),
            carry, jnp.int32(-1), jnp.asarray(True), overflow0)
    final, cc, _pend, _ps, ovf = jax.lax.while_loop(cond, body, init)
    if return_carry:
        return final, ovf, cc
    return final, ovf
