"""Batched node-frontier branch-and-bound for hybrid MPC.

A batched redesign of the per-lane depth-first B&B (ops/bnb.py, the
analog of DAQP's MIQP solver invoked by the reference at
src/utils.jl:277-280). The per-lane formulation nests the relaxation
solver's ``while_loop`` inside each lane's node loop under ``vmap`` --
an op-granular, highly divergent program. Here the tree search is
restructured around the batch:

  * every lane keeps its own DFS node stack (fixed capacity), but each
    outer ROUND pops exactly one node per lane and solves the whole
    frontier of node relaxations as ONE batched solver phase (the
    vmapped XLA inverse-update loop, per-lane equality masks for the
    fixed binary rows; ``make_xla_relax``);
  * branching, pruning, and incumbent updates are plain batched XLA ops
    between rounds;
  * nodes whose parent bound already exceeds the incumbent are discarded
    at pop time (an inner solve-free pop loop), so lanes do not burn
    rounds on prunable nodes.

Child nodes are warm-started from the parent relaxation's multipliers
and working set (DAQP-style workspace reuse).

The final incumbent is re-solved in float64 from its optimal active set
(``polish_solution``), so branching in f32 costs accuracy only in which
near-tied node wins, never in the returned controls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .dual_active_set import (
    LDPArrays,
    Solution,
    _active_set_loop_iu,
    polish_solution,
)

PREC = jax.lax.Precision.HIGHEST


class FrontierState(NamedTuple):
    stack_fixed: jax.Array  # (B, cap, m) bool: binary rows fixed at a bound
    stack_side: jax.Array   # (B, cap, m) bool: which bound (True = upper)
    stack_lam: jax.Array    # (B, cap, m) warm-start multipliers
    stack_act: jax.Array    # (B, cap, m) bool warm-start working set
    stack_ws: jax.Array     # (B, cap, m) bool warm-start working-set sides
    stack_bound: jax.Array  # (B, cap) parent relaxation value (lower bound)
    top: jax.Array          # (B,) int32
    inc_fval: jax.Array     # (B,)
    inc_lam: jax.Array      # (B, m)
    inc_active: jax.Array   # (B, m) bool
    inc_side: jax.Array     # (B, m) bool
    inc_found: jax.Array    # (B,) bool
    nodes: jax.Array        # (B,) int32
    iters: jax.Array        # (B,) int32
    exhausted: jax.Array    # (B,) bool: certificate incomplete (a node was
    #   pruned unconverged -- iteration cap OR a failed full-row residual
    #   check, which on cholesky nodes covers genuinely infeasible nodes)
    capped: jax.Array       # (B,) bool: TRUE budget exhaustion only (a node
    #   relaxation hit its iteration cap); drives the 1-vs-2 status split


def make_xla_relax(arrays: LDPArrays, *, max_iter: int, primal_tol: float,
                   sign_tol: float, mode: str = "iu") -> Callable:
    """Node-relaxation solver: vmapped XLA loop (any backend/dtype; the
    CPU/f64 differential-test path).

    ``mode="iu"``: the GI inverse-update loop -- fast, with dual-ray
    infeasibility detection. ``mode="cholesky"``: the ridge-regularized
    masked-Cholesky loop -- O(m^3) per iteration but the only scheme that
    converges on massively dual-degenerate problems (invpend_contact's
    root relaxation carries 170 active rows against rank(G) = 70; the GI
    scheme cycles or fabricates a dual ray there even with an exact
    inverse). A converged Cholesky node is feasibility-checked against
    the full row set before it is trusted (pseudo-solution guard,
    ``_primal_feasible``); infeasible nodes surface as that check
    failing, never as a false 'no integer-feasible point'."""
    dtype = arrays.G.dtype

    if mode == "cholesky":
        from .dual_active_set import _active_set_loop, _primal_feasible

        def relax(du_n, dl_n, eq_lane, lam0, act0, side0):
            def one(dut, dlt, eql, l0, a0, s0):
                st = _active_set_loop(
                    arrays, dut, dlt, eql, arrays.is_immutable,
                    l0.astype(dtype), a0, s0,
                    max_iter=max_iter, primal_tol=primal_tol,
                    sign_tol=sign_tol, use_cholesky=True,
                )
                feas = _primal_feasible(arrays, dut, dlt, st.lam,
                                        st.active, st.side, primal_tol)
                # a failed full-row residual check is routed to the
                # UNCONVERGED path (exhausted, like iteration-cap
                # exhaustion), never the infeasibility prune: on a
                # degenerate set the ridge residual of a feasible node can
                # spuriously exceed the threshold, and pruning it could
                # certify a suboptimal incumbent. Genuinely
                # infeasible nodes land here too -- they still prune (an
                # unconverged node is never expanded) but mark the lane's
                # certificate incomplete instead of claiming -2. The 7th
                # element separates TRUE iteration-cap exhaustion (the
                # only signal that downgrades a found incumbent from
                # proven-optimal 1 to best-under-budget 2).
                return (st.lam, st.active, st.side, st.iters,
                        st.done & feas, jnp.zeros_like(feas), ~st.done)

            return jax.vmap(one)(du_n, dl_n, eq_lane, lam0, act0, side0)

        return relax

    def relax(du_n, dl_n, eq_lane, lam0, act0, side0):
        st = jax.vmap(
            lambda dut, dlt, eql, l0, a0, s0: _active_set_loop_iu(
                arrays, dut, dlt, eql, arrays.is_immutable,
                l0.astype(dtype), a0, s0,
                max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
            )
        )(du_n, dl_n, eq_lane, lam0, act0, side0)
        return (st.lam, st.active, st.side, st.iters, st.done, st.infeas,
                ~st.done & ~st.infeas)

    return relax


def solve_bnb_frontier(
    arrays: LDPArrays,
    arrays_hi: LDPArrays | None,
    thetas: jax.Array,
    relax: Callable,
    *,
    stack_cap: int = 64,
    node_limit: int = 1024,
    bin_tol: float = 1e-6,
    use_cholesky: bool = True,
    warm_nodes: bool = True,
) -> Solution:
    """Solve a batch of hybrid LDP instances with lockstep node rounds.

    ``relax(du_n, dl_n, eq_lane, lam0, act0, side0)`` solves the whole
    frontier of node relaxations and returns batched
    ``(lam, act, side, iters, done, infeas)``.

    ``warm_nodes=False`` drops the warm-start stacks entirely (cold node
    solves).
    """
    dtype = arrays.G.dtype
    m = arrays.G.shape[0]
    n = arrays.u_off.shape[0]
    B = thetas.shape[0]
    th = thetas.astype(dtype)
    # finite sentinel: 1e30 dominates every reachable fval/bound in both
    # f32 and f64 and keeps sentinel arithmetic free of inf/NaN (inf < inf
    # incumbent tests, 0 * inf masks)
    big = jnp.asarray(min(float(jnp.finfo(dtype).max), 1e30), dtype)
    bidx = jnp.arange(B)
    is_bin = arrays.is_binary
    is_eq = arrays.is_eq
    immut = arrays.is_immutable
    up_f, lo_f = arrays.up_finite, arrays.lo_finite

    # theta-dependent pieces, shared by every node of a lane
    du_t = arrays.du + jnp.dot(th, arrays.Dth.T, precision=PREC)
    dl_t = arrays.dl + jnp.dot(th, arrays.Dth.T, precision=PREC)
    U0 = arrays.u_off + jnp.dot(th, arrays.Uth_off.T, precision=PREC)
    f_t = arrays.f + jnp.dot(th, arrays.f_theta.T, precision=PREC)

    def prune_tops(top, inc_found, inc_fval, stack_bound):
        """Pop (discard) stacked nodes whose parent bound already exceeds
        the incumbent -- no relaxation solve needed."""
        def top_bound(t):
            i = jnp.maximum(t - 1, 0)
            return jnp.take_along_axis(stack_bound, i[:, None], axis=1)[:, 0]

        def cond(t):
            return jnp.any((t > 0) & inc_found & (top_bound(t) >= inc_fval))

        def body(t):
            prunable = (t > 0) & inc_found & (top_bound(t) >= inc_fval)
            return t - prunable.astype(jnp.int32)

        return jax.lax.while_loop(cond, body, top)

    def body(s: FrontierState) -> FrontierState:
        top = prune_tops(s.top, s.inc_found, s.inc_fval, s.stack_bound)
        has_node = (top > 0) & (s.nodes < node_limit)
        hn = has_node[:, None]
        idx = jnp.maximum(top - 1, 0)
        gat = lambda st: jnp.take_along_axis(st, idx[:, None, None], axis=1)[:, 0]
        fixed = gat(s.stack_fixed) & hn
        fside = gat(s.stack_side)
        top = top - has_node.astype(jnp.int32)

        eq_lane = is_eq[None, :] | fixed
        d_f = jnp.where(fside, du_t, dl_t)
        du_n = jnp.where(fixed, d_f, du_t)
        dl_n = jnp.where(fixed, d_f, dl_t)
        if warm_nodes:
            lam0 = gat(s.stack_lam)
            act0 = gat(s.stack_act) | eq_lane
            side0 = jnp.where(fixed, fside, gat(s.stack_ws))
        else:
            lam0 = jnp.zeros((B, m), dtype)
            act0 = jnp.zeros((B, m), bool)
            side0 = jnp.ones((B, m), bool)

        lam, act, side, it_in, done, infeas, capped = relax(
            du_n, dl_n, eq_lane, lam0, act0, side0)

        U = U0 - jnp.dot(lam.astype(dtype), arrays.HinvET.T, precision=PREC)
        fval = (0.5 * jnp.einsum("bi,ij,bj->b", U, arrays.H, U, precision=PREC)
                + jnp.sum(f_t * U, axis=1))
        feasible = done & ~infeas
        unconverged = has_node & ~done & ~infeas
        pruned = (~feasible) | (s.inc_found & (fval >= s.inc_fval))

        # fractionality of unfixed binary rows: distance to the nearer
        # viable bound (matches ops/bnb.py)
        c = jnp.dot(lam.astype(dtype), arrays.G.T, precision=PREC)
        slack_up = jnp.where(up_f[None, :], du_t + c, big)
        slack_lo = jnp.where(lo_f[None, :], -dl_t - c, big)
        frac = jnp.minimum(slack_up, slack_lo)
        branchable = is_bin[None, :] & ~fixed & ~immut[None, :] & (up_f | lo_f)[None, :]
        frac = jnp.where(branchable, frac, -big)
        jb = jnp.argmax(frac, axis=1)
        frac_jb = jnp.take_along_axis(frac, jb[:, None], axis=1)[:, 0]
        integral = frac_jb <= bin_tol

        better = feasible & integral & (~pruned) & (fval < s.inc_fval) & has_node
        bt = better[:, None]
        inc_fval = jnp.where(better, fval, s.inc_fval)
        inc_lam = jnp.where(bt, lam, s.inc_lam)
        # pin every fixed binary row at its branched bound/side: the f64
        # polish solves the UNCLAMPED problem, and a clamped row satisfied
        # with zero multiplier never enters the working set (same fix as
        # the incremental path; without it the polish drifts off the
        # branched bound and returns a wrong optimum with status 1)
        inc_active = jnp.where(bt, act | fixed, s.inc_active)
        inc_side = jnp.where(bt, jnp.where(fixed, fside, side), s.inc_side)
        inc_found = s.inc_found | better

        # branch on jb: push far bound first, near bound last (DFS pops near)
        branch = (~pruned) & (~integral) & has_node
        onehot = jnp.arange(m)[None, :] == jb[:, None]
        child_fixed = fixed | onehot
        su_jb = jnp.take_along_axis(slack_up, jb[:, None], axis=1)[:, 0]
        sl_jb = jnp.take_along_axis(slack_lo, jb[:, None], axis=1)[:, 0]
        near_up = (su_jb <= sl_jb)[:, None]
        far_side = jnp.where(onehot, ~near_up, fside)
        near_side = jnp.where(onehot, near_up, fside)
        lo_jb = lo_f[jb]
        up_jb = up_f[jb]
        far_viable = jnp.where(near_up[:, 0], lo_jb, up_jb)
        w_side_far = jnp.where(onehot, ~near_up, side)
        w_side_near = jnp.where(onehot, near_up, side)
        # an unconverged parent's fval is not a valid bound for children
        child_bound = jnp.where(unconverged, -big, fval)

        st = (s.stack_fixed, s.stack_side, s.stack_lam, s.stack_act,
              s.stack_ws, s.stack_bound)

        def push(st, top, fix, sd, ws, bd, do):
            sf, ss, sl, sa, sw, sb = st
            do = do & (top < stack_cap)
            dom = do[:, None]
            ix = jnp.minimum(top, stack_cap - 1)
            put = lambda A, v: A.at[bidx, ix].set(jnp.where(dom, v, A[bidx, ix]))
            sf = put(sf, fix)
            ss = put(ss, sd)
            if warm_nodes:
                sl = put(sl, lam)
                sa = put(sa, act)
                sw = put(sw, ws)
            sb = sb.at[bidx, ix].set(jnp.where(do, bd, sb[bidx, ix]))
            return (sf, ss, sl, sa, sw, sb), top + do.astype(jnp.int32)

        st, top = push(st, top, child_fixed, far_side, w_side_far, child_bound,
                       branch & far_viable)
        st, top = push(st, top, child_fixed, near_side, w_side_near, child_bound,
                       branch)

        return FrontierState(
            *st, top, inc_fval, inc_lam, inc_active, inc_side, inc_found,
            s.nodes + has_node.astype(jnp.int32),
            s.iters + jnp.where(has_node, it_in.astype(jnp.int32), 0),
            s.exhausted | unconverged,
            s.capped | (has_node & capped),
        )

    def cond(s: FrontierState):
        return jnp.any((s.top > 0) & (s.nodes < node_limit))

    cap_w = stack_cap if warm_nodes else 1
    init = FrontierState(
        stack_fixed=jnp.zeros((B, stack_cap, m), bool),
        stack_side=jnp.zeros((B, stack_cap, m), bool),
        stack_lam=jnp.zeros((B, cap_w, m), dtype),
        stack_act=jnp.zeros((B, cap_w, m), bool),
        stack_ws=jnp.ones((B, cap_w, m), bool),
        stack_bound=jnp.full((B, stack_cap), -big, dtype),
        top=jnp.ones(B, jnp.int32),  # root node: nothing fixed, cold start
        inc_fval=jnp.full(B, big, dtype),
        inc_lam=jnp.zeros((B, m), dtype),
        inc_active=jnp.zeros((B, m), bool),
        inc_side=jnp.zeros((B, m), bool),
        inc_found=jnp.zeros(B, bool),
        nodes=jnp.zeros(B, jnp.int32),
        iters=jnp.zeros(B, jnp.int32),
        exhausted=jnp.zeros(B, bool),
        capped=jnp.zeros(B, bool),
    )
    final = jax.lax.while_loop(cond, body, init)

    # a TRULY budget-limited lane (a node relaxation hit its iteration
    # cap, or the lane hit node_limit) can still hold an exact incumbent,
    # but the tree was not fully explored: report 2 (best found under
    # budget) instead of overstating 1 (proven optimal).
    # `exhausted` additionally covers unconverged-node prunes (on
    # cholesky nodes: overwhelmingly genuinely infeasible nodes, whose
    # pruning preserves optimality); it keeps driving only the -1/-2
    # split, as before.
    budgeted = final.capped | (final.nodes >= node_limit)
    status = jnp.where(
        final.inc_found,
        jnp.where(budgeted, jnp.int32(2), jnp.int32(1)),
        jnp.where(final.exhausted | budgeted, jnp.int32(-1), jnp.int32(-2)))

    # exact f64 re-solve of each incumbent's optimal active set (includes
    # the fixed binary rows, active at their branched bound)
    hi = arrays if arrays_hi is None else arrays_hi
    sol = jax.vmap(
        lambda t, a, sd: polish_solution(hi, t, a, sd, use_cholesky=use_cholesky)
    )(thetas, final.inc_active, final.inc_side)
    zero_U = jnp.zeros((B, n), sol.U.dtype)
    found = final.inc_found
    fm = found[:, None]
    return Solution(
        jnp.where(fm, sol.U, zero_U),
        jnp.where(fm, sol.lam, jnp.zeros((B, m), sol.lam.dtype)),
        final.inc_active, final.inc_side,
        jnp.where(found, sol.fval, big),
        final.iters, status,
    )
