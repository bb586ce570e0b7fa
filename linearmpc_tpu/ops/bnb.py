"""Branch-and-bound over dual active-set relaxations for hybrid MPC.

Batched analog of DAQP's MIQP branch-and-bound (reference: ccall at
src/utils.jl:277-280, senses BINARY at src/mpc2mpqp.jl:883-884). A binary
constraint must hold with equality at its upper or lower bound. Each node
fixes a subset of binary rows to one bound and solves the relaxation with
the same masked dual active-set kernel (``forced_mask``/``forced_side``).

The search is depth-first with a fixed-capacity per-lane node stack so that
thousands of instances run in lockstep under ``vmap``: lanes that finish
early are masked out by the ``while_loop`` batching rule. Branching picks
the most fractional unfixed binary row; children are pushed so the bound
nearer the relaxed solution is explored first.

Child nodes are WARM-STARTED from the parent relaxation's multipliers and
working set (DAQP reuses its workspace across nodes the same way,
reference src/utils.jl:277-282 node cleanup): the child problem differs
from the parent only in one row's bounds, so the parent's working set is
one or two active-set changes from the child's optimum. The dual method
accepts any starting working set -- the first iteration re-solves the
masked system exactly -- so warm starts change iteration counts, never
solutions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .dual_active_set import LDPArrays, Solution, solve_single


class BnBState(NamedTuple):
    stack_fixed: jax.Array  # (cap, m) bool
    stack_side: jax.Array   # (cap, m) bool
    stack_lam: jax.Array    # (cap, m) warm-start multipliers (parent node)
    stack_act: jax.Array    # (cap, m) bool warm-start working set
    stack_ws: jax.Array     # (cap, m) bool warm-start working-set sides
    top: jax.Array          # () int32
    inc_fval: jax.Array     # () incumbent objective
    inc_U: jax.Array        # (n,)
    inc_lam: jax.Array      # (m,)
    inc_active: jax.Array   # (m,) bool
    inc_side: jax.Array     # (m,) bool
    inc_found: jax.Array    # () bool
    nodes: jax.Array        # () int32
    iters: jax.Array        # () int32 total inner iterations


def solve_bnb_single(
    ldp: LDPArrays,
    theta: jax.Array,
    *,
    stack_cap: int = 64,
    node_limit: int = 1024,
    max_iter: int = 500,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-12,
    bin_tol: float = 1e-6,
    use_cholesky: bool = True,
    warm_nodes: bool = True,
) -> Solution:
    """Solve one hybrid LDP instance. Wrap in ``jax.vmap`` for batches."""
    dtype = ldp.G.dtype
    m = ldp.G.shape[0]
    n = ldp.u_off.shape[0]
    theta = theta.astype(dtype)
    is_bin = ldp.is_binary

    du_t = ldp.du + jnp.dot(ldp.Dth, theta, precision=jax.lax.Precision.HIGHEST)
    dl_t = ldp.dl + jnp.dot(ldp.Dth, theta, precision=jax.lax.Precision.HIGHEST)
    # finite sentinel: 1e30 dominates every reachable fval/bound in both
    # f32 and f64 and keeps sentinel arithmetic free of inf/NaN
    big = jnp.asarray(min(float(jnp.finfo(dtype).max), 1e30), dtype)

    def body(s: BnBState) -> BnBState:
        # pop the top node
        node_idx = s.top - 1
        fixed = s.stack_fixed[node_idx]
        side = s.stack_side[node_idx]
        top = s.top - 1

        warm = dict(
            lam0=s.stack_lam[node_idx],
            active0=s.stack_act[node_idx],
            side0=s.stack_ws[node_idx],
        ) if warm_nodes else {}
        sol = solve_single(
            ldp, theta, **warm,
            max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
            forced_mask=fixed, forced_side=side, use_cholesky=use_cholesky,
        )

        feasible = sol.status > 0
        pruned = (~feasible) | (s.inc_found & (sol.fval >= s.inc_fval))

        # fractionality of unfixed binary rows: distance to the nearer
        # *viable* (finite) bound -- never branch onto an infinite bound
        c = jnp.dot(ldp.G, sol.lam, precision=jax.lax.Precision.HIGHEST)
        slack_up = jnp.where(ldp.up_finite, du_t + c, big)
        slack_lo = jnp.where(ldp.lo_finite, -dl_t - c, big)
        frac = jnp.minimum(slack_up, slack_lo)
        branchable = is_bin & ~fixed & ~ldp.is_immutable & (ldp.up_finite | ldp.lo_finite)
        frac = jnp.where(branchable, frac, -big)
        jb = jnp.argmax(frac)
        integral = frac[jb] <= bin_tol

        # incumbent update
        better = feasible & integral & (~pruned) & (sol.fval < s.inc_fval)
        inc_fval = jnp.where(better, sol.fval, s.inc_fval)
        inc_U = jnp.where(better, sol.U, s.inc_U)
        inc_lam = jnp.where(better, sol.lam, s.inc_lam)
        inc_active = jnp.where(better, sol.active, s.inc_active)
        inc_side = jnp.where(better, sol.side, s.inc_side)
        inc_found = s.inc_found | better

        # branch on jb: push the farther bound first, nearer bound last (DFS pops it next)
        branch = (~pruned) & (~integral)
        onehot = jnp.arange(m) == jb
        child_fixed = fixed | onehot
        near_up = slack_up[jb] <= slack_lo[jb]
        far_side = jnp.where(onehot, ~near_up, side)
        near_side = jnp.where(onehot, near_up, side)
        far_viable = jnp.where(near_up, ldp.lo_finite[jb], ldp.up_finite[jb])
        # children inherit the parent relaxation's dual state; the branched
        # row's working-set side follows the bound it is being forced to
        w_lam, w_act = sol.lam, sol.active
        w_side_far = jnp.where(onehot, ~near_up, sol.side)
        w_side_near = jnp.where(onehot, near_up, sol.side)

        def push(st, top, fix, sd, wl, wa, ws, do):
            sf, ss, sl, sa, sw = st
            sf = jnp.where(do, sf.at[top].set(fix), sf)
            ss = jnp.where(do, ss.at[top].set(sd), ss)
            sl = jnp.where(do, sl.at[top].set(wl), sl)
            sa = jnp.where(do, sa.at[top].set(wa), sa)
            sw = jnp.where(do, sw.at[top].set(ws), sw)
            return (sf, ss, sl, sa, sw), top + jnp.int32(do)

        st = (s.stack_fixed, s.stack_side, s.stack_lam, s.stack_act, s.stack_ws)
        st, top = push(st, top, child_fixed, far_side, w_lam, w_act, w_side_far,
                       branch & far_viable)
        st, top = push(st, top, child_fixed, near_side, w_lam, w_act, w_side_near,
                       branch & (top < stack_cap))

        return BnBState(
            *st, top, inc_fval, inc_U, inc_lam, inc_active, inc_side,
            inc_found, s.nodes + 1, s.iters + sol.iters,
        )

    def cond(s: BnBState):
        return (s.top > 0) & (s.nodes < node_limit)

    init = BnBState(
        stack_fixed=jnp.zeros((stack_cap, m), dtype=bool),
        stack_side=jnp.zeros((stack_cap, m), dtype=bool),
        stack_lam=jnp.zeros((stack_cap, m), dtype=dtype),
        stack_act=jnp.zeros((stack_cap, m), dtype=bool),
        stack_ws=jnp.ones((stack_cap, m), dtype=bool),
        top=jnp.int32(1),  # root node: nothing fixed, cold start
        inc_fval=big,
        inc_U=jnp.zeros(n, dtype=dtype),
        inc_lam=jnp.zeros(m, dtype=dtype),
        inc_active=jnp.zeros(m, dtype=bool),
        inc_side=jnp.zeros(m, dtype=bool),
        inc_found=jnp.asarray(False),
        nodes=jnp.int32(0),
        iters=jnp.int32(0),
    )
    final = jax.lax.while_loop(cond, body, init)
    # 1 = proven optimal (tree fully explored); 2 = exact incumbent but
    # the node limit stopped the search early (the frontier reports the
    # same distinction)
    budgeted = (final.top > 0) & (final.nodes >= node_limit)
    status = jnp.where(
        final.inc_found,
        jnp.where(budgeted, jnp.int32(2), jnp.int32(1)),
        jnp.int32(-2))
    return Solution(
        final.inc_U, final.inc_lam, final.inc_active, final.inc_side,
        final.inc_fval, final.iters, status,
    )
