"""Solver engine: jitted entry points around the batched dual active-set core.

Plays the role of the reference's DAQP workspace (``opt_model``,
src/setup.jl:11-26 + src/utils.jl:268-283): holds the lowered LDP arrays on
device, jit-compiles the solve paths once, and exposes host-friendly
single-instance and batched entry points (plus branch-and-bound for hybrid
problems).

Batched solves take one of these routes (``SolverEngine.bulk_route``):

  * ``fused``: m <= ``PALLAS_MAX_M`` with a subset-inverse cache, float32
    bulk on a GPU -- the whole bulk loop in one Triton kernel
    (ops/pallas_solver.py), then float64 finishing tiers;
  * ``compact``: larger continuous problems with float64 finishing -- the
    compact working-set loop (ops/compact_iu.py) and float64 guard tiers;
  * ``frontier`` / ``dfs``: hybrid problems -- batched node-frontier or
    per-lane depth-first branch-and-bound;
  * ``lex``: lexicographic hierarchies (ops/hierarchy.py);
  * ``vmap``: everything else -- ``solve_single`` vmapped over the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .dual_active_set import (
    LDPArrays,
    Solution,
    finish_from_state,
    polish_solution,
    solve_single,
    to_device_arrays,
)
from .ldp import LDPData

HIGHEST = jax.lax.Precision.HIGHEST


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def accelerator_platform() -> str:
    """The platform batched solves compile for (``jax.default_backend()``:
    "cpu" or "gpu"); the one query every route choice below reads."""
    return jax.default_backend()


def _kkt_badness(hi, theta, sol_lam, sol_act, sol_side):
    """f64 KKT residual of a polished lane: primal violation of inactive
    rows + multiplier sign violation of active rows."""
    du_hi = hi.du + hi.Dth @ theta
    dl_hi = hi.dl + hi.Dth @ theta
    c = hi.G @ sol_lam
    v_up = jnp.where(~sol_act & ~hi.is_immutable, -(du_hi + c), -jnp.inf)
    v_lo = jnp.where(~sol_act & ~hi.is_immutable, dl_hi + c, -jnp.inf)
    primal = jnp.maximum(jnp.max(v_up), jnp.max(v_lo))
    sign = jnp.max(jnp.where(
        sol_act & ~hi.is_eq,
        jnp.where(sol_side, -sol_lam, sol_lam), -jnp.inf,
    ))
    return jnp.maximum(primal, sign)


def _merge_top(base: Solution, upd: Solution, idx, needs_fix) -> Solution:
    """Scatter ``upd`` into the ``idx`` lanes of ``base`` where ``needs_fix``."""
    def merge(b, u):
        keep = needs_fix.reshape((-1,) + (1,) * (u.ndim - 1))
        return b.at[idx].set(jnp.where(keep, u, b[idx]))

    return Solution(*(merge(b, u) for b, u in zip(base, upd)))


class SolverEngine:
    def __init__(
        self,
        ldp: LDPData,
        *,
        dtype=None,
        iter_limit: int = 1000,
        primal_tol: float = 1e-6,
        sign_tol: float = 1e-12,
        has_binaries: bool = False,
        bnb_node_limit: int = 4096,
        symmetric: bool = True,
        polish: bool | None = None,
        bulk_unroll: int | None = None,
        lexicographic: bool = False,
        soft_weight: float = 1e6,
        interpret: bool = False,
    ):
        """``interpret=True`` runs the fused small-m kernel through the
        Pallas interpreter (CPU tests); without it the kernel is used only
        when the engine compiles for a GPU."""
        self.ldp = ldp
        # sequential lexicographic hierarchy (exact DAQP break_points
        # semantics); when enabled it takes over every solve entry
        self.lex = None
        if lexicographic:
            from .hierarchy import LexSolver

            self.lex = LexSolver(
                ldp, soft_weight=soft_weight, iter_limit=iter_limit,
                primal_tol=primal_tol, sign_tol=max(sign_tol, 1e-11),
            )
        self.dtype = default_dtype() if dtype is None else dtype
        self.interpret = bool(interpret)
        # working-set inverse cache: collapses each iteration's KKT solve to
        # a gather + matvec for small m (see ops/ldp.py)
        from .ldp import SUBSET_CACHE_MAX_M, precompute_subset_inverses

        subset_inv = None
        if ldp.m <= SUBSET_CACHE_MAX_M and ldp.m > 0:
            subset_inv = precompute_subset_inverses(ldp)
        self._subset_inv = subset_inv
        self.arrays: LDPArrays = to_device_arrays(ldp, self.dtype, subset_inv)
        self.iter_limit = int(iter_limit)
        # tolerances must sit above the iteration dtype's noise floor or
        # marginal multipliers flip sign forever (add/remove cycling); the
        # f64 polish restores full accuracy afterwards
        if self.dtype == jnp.float32:
            primal_tol = max(primal_tol, 2e-5)
            sign_tol = max(sign_tol, 1e-6)
        self.primal_tol = float(primal_tol)
        self.sign_tol = float(sign_tol)
        self.has_binaries = bool(has_binaries)
        self.bnb_node_limit = int(bnb_node_limit)
        self.symmetric = bool(symmetric)
        # float32 iterations + float64 active-set polish by default on
        # reduced-precision paths; float64 paths need no polish
        self.polish = (self.dtype != jnp.float64) if polish is None else bool(polish)
        self.arrays_hi = to_device_arrays(ldp, jnp.float64, subset_inv) if self.polish else None

        # unrolled bulk phase: trades redundant masked iterations for fewer
        # kernel dispatches. Opt-in: the unrolled graph compiles much more
        # slowly, so the early-exit while_loop stays the default.
        self.bulk_unroll = 0 if bulk_unroll is None else int(bulk_unroll)
        kw = dict(
            max_iter=self.iter_limit, primal_tol=self.primal_tol, sign_tol=self.sign_tol,
            use_cholesky=self.symmetric, bulk_unroll=self.bulk_unroll,
            # O(m^2) recursive Woodbury inverse updates for the bulk phase
            # beyond the subset cache (DAQP's recursive-factorization
            # analog); requires the f64 continuation to repair drift, and
            # the R carry costs m^2 per lane
            bulk_inverse_updates=(
                subset_inv is None and self.symmetric and self.polish and ldp.m <= 512
            ),
        )
        self._solve_kw = kw

        def _single(arrays, hi, theta):
            return solve_single(arrays, theta, ldp_hi=hi, **kw)

        def _batched(arrays, hi, thetas, lam0=None, act0=None, side0=None):
            if lam0 is None:
                return jax.vmap(lambda th: solve_single(arrays, th, ldp_hi=hi, **kw))(thetas)
            return jax.vmap(
                lambda th, l0, a0, s0: solve_single(arrays, th, l0, a0, s0, ldp_hi=hi, **kw)
            )(thetas, lam0, act0, side0)

        self._single = jax.jit(_single)
        self._batched = jax.jit(_batched)

        from .pallas_solver import PALLAS_MAX_M

        if self.lex is not None:
            self.bulk_route = "lex"
        elif self.has_binaries:
            self._build_hybrid(kw)
        elif (self.dtype == jnp.float32 and self.polish
              and subset_inv is not None and ldp.m <= PALLAS_MAX_M
              and (accelerator_platform() == "gpu" or self.interpret)):
            self._build_fused(subset_inv)
            self.bulk_route = "fused"
        elif self.polish and self.symmetric and subset_inv is None:
            self._build_compact()
            self.bulk_route = "compact"
        else:
            self.bulk_route = "vmap"

    # -- small m: the whole f32 bulk loop in one Triton kernel ------------
    def _build_fused(self, subset_inv):
        """Fused bulk kernel + f64 finishing: tier 1 re-solves every lane's
        final working set exactly (``polish_solution``) and measures its
        f64 KKT residual; tier 2, only when some lane is not clean, sends
        up to ``STRAGGLER_K`` of them through the f64 continuation."""
        from .pallas_solver import make_bulk_phase

        ldp = self.ldp
        m = ldp.m
        Dth32 = jnp.asarray(ldp.Dth, jnp.float32)
        du32 = jnp.asarray(ldp.du, jnp.float32)
        dl32 = jnp.asarray(ldp.dl, jnp.float32)
        eq = jnp.asarray(ldp.is_eq)
        # with exact in-kernel arithmetic the f32 iteration converges in
        # <= 2m iterations on the pendulum problem; the margin covers
        # harder geometries and leftovers route through the f64 tier
        bulk_cap = min(self.iter_limit, 2 * m + 20)
        STRAGGLER_K = 256  # lanes routed through the full f64 continuation
        bulk = make_bulk_phase(
            subset_inv, ldp.G, ldp.is_eq, ldp.is_immutable, max_iter=bulk_cap,
            primal_tol=self.primal_tol, sign_tol=self.sign_tol,
            interpret=self.interpret)
        use_chol = self.symmetric

        def _fused_batch(hi, thetas, lam0=None, act0=None, side0=None):
            B = thetas.shape[0]
            if lam0 is None:
                lam0 = jnp.zeros((B, m), jnp.float32)
                act0 = jnp.zeros((B, m), bool)
                side0 = jnp.ones((B, m), bool)
            th32 = thetas.astype(jnp.float32)
            du_t = du32 + jnp.dot(th32, Dth32.T, precision=HIGHEST)
            dl_t = dl32 + jnp.dot(th32, Dth32.T, precision=HIGHEST)
            lam, act, side, iters, _done = bulk(
                du_t, dl_t, lam0.astype(jnp.float32), act0 | eq, side0)
            thetas = thetas.astype(jnp.float64)
            sol = jax.vmap(
                lambda th, a, s, it: polish_solution(
                    hi, th, a, s, use_cholesky=use_chol, iters=it)
            )(thetas, act, side, iters)
            bad = jax.vmap(lambda th, l, a, s: _kkt_badness(hi, th, l, a, s))(
                thetas, sol.lam, sol.active, sol.side)
            # a lane is optimal iff its f64 KKT residual is clean, whether
            # or not the bulk phase hit its budget (NaN counts as unclean)
            clean = bad <= 1e-8
            sol = sol._replace(status=jnp.where(clean, jnp.int32(1), jnp.int32(-1)))

            def fix(sol):
                # stragglers sit a few working-set changes from optimal
                # after the bulk phase; a tight budget keeps the lockstep
                # f64 loop short (unconverged lanes report status -1)
                unclean, idx = jax.lax.top_k(jnp.where(clean, 0, 1), min(STRAGGLER_K, B))
                upd = jax.vmap(
                    lambda th, l0, a0, s0, it0: finish_from_state(
                        hi, th, l0, a0, s0, it0, use_cholesky=use_chol,
                        max_iter=24)
                )(thetas[idx], lam[idx], act[idx], side[idx], iters[idx])
                return _merge_top(sol, upd, idx, unclean > 0)

            return jax.lax.cond(jnp.any(~clean), fix, lambda s: s, sol)

        self._fused_batched = jax.jit(_fused_batch)

        def _fused_rollout_solve(thetas, lam0, act0, side0):
            """Warm-started whole-batch solve for use INSIDE a traced
            closed-loop scan. Returns (U, lam, act, side, iters, status)."""
            sol = _fused_batch(self.arrays_hi, thetas, lam0, act0, side0)
            return sol.U, sol.lam, sol.active, sol.side, sol.iters, sol.status

        self.fused_rollout_solve = _fused_rollout_solve

    # -- larger m: compact working-set bulk + f64 guard tiers ------------
    def _build_compact(self):
        """The bulk phase carries an s_max x s_max working-set inverse per
        lane (the lockstep analog of DAQP's recursive LDL' of the ACTIVE
        rows) instead of the full (m, m) inverse, so per-iteration work is
        O(s_max^2 + m) per lane."""
        from .compact_iu import _active_set_loop_ciu

        ldp = self.ldp
        m_c = ldp.m
        # n + 8 slots: the optimum's working set is at most n rows
        # generically; lanes that overflow the capacity are flagged and
        # re-solved by the f64 guard tiers at larger capacities
        s_max = min(m_c, max(16, ldp.n + 8))
        # equality rows are permanently active: a capacity below their
        # count would make EVERY lane's initial slot carry overflow
        n_eq_c = int(np.asarray(ldp.is_eq).sum())
        s_max = max(s_max, min(m_c, n_eq_c + 8))
        s_max = min(m_c, ((s_max + 7) // 8) * 8)
        self.ciu_s_max = s_max
        # f64 Richardson passes through the compact-slot preconditioner;
        # a lane whose refinement stalls fails the f64 KKT check below and
        # is routed to the guard tiers, so the count trades guard traffic
        # against finishing cost, never correctness
        REFINE_C = 4
        bulk_cap_c = min(self.iter_limit, 2 * m_c + 24)
        f64 = jnp.float64
        KKT_TOL = 1e-8
        tol_f64 = dict(primal_tol=min(self.primal_tol, 1e-6), sign_tol=1e-11)

        def _kkt_bad(hi, lam, act, side, du_h, dl_h):
            """f64 KKT residual per lane: inactive-row primal violation,
            active-row sign violation, and the working-set system residual
            (a stalled refinement leaves active rows violated, invisible
            to the first two)."""
            actf = act.astype(f64)
            rhs = -actf * jnp.where(side, du_h, dl_h)
            c = jnp.dot(lam, hi.G.T)
            inact = ~act & ~hi.is_immutable
            v_up = jnp.where(inact, -(du_h + c), -jnp.inf)
            v_lo = jnp.where(inact, dl_h + c, -jnp.inf)
            primal = jnp.max(jnp.maximum(v_up, v_lo), axis=1)
            sgn = jnp.max(jnp.where(
                act & ~hi.is_eq, jnp.where(side, -lam, lam), -jnp.inf), axis=1)
            res = actf * jnp.dot(lam * actf, hi.G_solve.T) + (1.0 - actf) * lam - rhs
            return jnp.maximum(jnp.maximum(primal, sgn), jnp.max(jnp.abs(res), axis=1))

        def _f64_resolve(hi, du_h, dl_h, th64, s_g, cap_g):
            """Cold f64 compact re-solve of a lane subset (iters relative).
            The loop's carried inverse drifts on degenerate working sets
            (observed at m=1024: the right working set with multipliers
            ~1e-4 off), so the final working set is re-solved exactly on
            its slots (least squares: degenerate sets are rank-deficient);
            status 1 only with a clean f64 KKT residual."""
            st, ovf, (_Rw, slots, occ) = jax.vmap(
                lambda dut, dlt: _active_set_loop_ciu(
                    hi, dut, dlt, hi.is_eq, hi.is_immutable,
                    jnp.zeros(m_c, f64), hi.is_eq, jnp.ones(m_c, bool),
                    s_max=s_g, max_iter=cap_g, return_carry=True, **tol_f64)
            )(du_h, dl_h)
            occf = occ.astype(f64)
            Mw = (hi.G_solve[slots[:, :, None], slots[:, None, :]]
                  * occf[:, :, None] * occf[:, None, :]
                  + jax.vmap(jnp.diag)(1.0 - occf))
            rhs = -jnp.where(st.side, du_h, dl_h) * st.active
            rhs_w = jnp.take_along_axis(rhs, slots, axis=1) * occf
            lam_w = jax.vmap(lambda A, b: jnp.linalg.lstsq(A, b, rcond=1e-12)[0])(Mw, rhs_w)
            lam = jnp.zeros_like(st.lam).at[jnp.arange(lam_w.shape[0])[:, None], slots].add(
                jnp.where(occ, lam_w, 0.0))
            U = (hi.u_off + jnp.dot(th64, hi.Uth_off.T)
                 - jnp.dot(lam, hi.HinvET.T))
            f_t = hi.f + jnp.dot(th64, hi.f_theta.T)
            fval = 0.5 * jnp.einsum("bi,ij,bj->b", U, hi.H, U) + jnp.sum(f_t * U, axis=1)
            clean = _kkt_bad(hi, lam, st.active, st.side, du_h, dl_h) <= KKT_TOL
            status = jnp.where(
                st.infeas, jnp.int32(-3),
                jnp.where(st.done & ~ovf & clean, jnp.int32(1), jnp.int32(-1)))
            return Solution(U, lam, st.active, st.side, fval, st.iters, status)

        def _ciu_batch(arr, hi, thetas, lam0=None, act0=None, side0=None):
            B = thetas.shape[0]
            th32 = thetas.astype(self.dtype)
            du_t = arr.du + jnp.dot(th32, arr.Dth.T, precision=HIGHEST)
            dl_t = arr.dl + jnp.dot(th32, arr.Dth.T, precision=HIGHEST)
            if lam0 is None:
                lam0 = jnp.zeros((B, m_c), self.dtype)
                act0 = jnp.zeros((B, m_c), bool)
                side0 = jnp.ones((B, m_c), bool)
            act0 = act0 | arr.is_eq
            st, ovf, cc = jax.vmap(
                lambda dut, dlt, l0, a0, s0: _active_set_loop_ciu(
                    arr, dut, dlt, arr.is_eq, arr.is_immutable,
                    l0.astype(self.dtype), a0, s0,
                    s_max=s_max, max_iter=bulk_cap_c,
                    primal_tol=self.primal_tol, sign_tol=self.sign_tol,
                    return_carry=True,
                )
            )(du_t, dl_t, lam0, act0, side0)
            act, side, iters, infeas32 = st.active, st.side, st.iters, st.infeas
            Rw, slots, occ = cc

            th64 = thetas.astype(f64)
            du_h = hi.du + jnp.dot(th64, hi.Dth.T)
            dl_h = hi.dl + jnp.dot(th64, hi.Dth.T)
            actf = act.astype(f64)
            actf32 = act.astype(jnp.float32)
            rhs = -actf * jnp.where(side, du_h, dl_h)
            occf = occ.astype(jnp.float32)
            brow = jnp.arange(B)[:, None]

            def applyR(v):
                # compact preconditioner: Rw on the working-set slots,
                # identity on inactive rows
                v32 = v.astype(jnp.float32)
                w = jnp.take_along_axis(v32, slots, axis=1) * occf
                y = jnp.einsum("bij,bj->bi", Rw, w, precision=HIGHEST)
                full = jnp.zeros_like(v32).at[brow, slots].add(jnp.where(occ, y, 0.0))
                return (full + v32 * (1.0 - actf32)).astype(f64)

            mask_apply = lambda v: actf * jnp.dot(v * actf, hi.G_solve.T) + (1.0 - actf) * v
            lam = applyR(rhs)
            for _ in range(REFINE_C):
                lam = lam + applyR(rhs - mask_apply(lam))
            U = hi.u_off + jnp.dot(th64, hi.Uth_off.T) - jnp.dot(lam, hi.HinvET.T)
            f_t = hi.f + jnp.dot(th64, hi.f_theta.T)
            fval = 0.5 * jnp.einsum("bi,ij,bj->b", U, hi.H, U) + jnp.sum(f_t * U, axis=1)

            bad = _kkt_bad(hi, lam, act, side, du_h, dl_h)
            # capacity-overflow lanes cannot be certified by their carry
            bad = jnp.where(ovf, jnp.inf, bad)

            # an f32-detected dual-unbounded ray keeps its -3 verdict and is
            # never promoted to optimal by a small residual (its lam is a
            # ray, not a solution); a clean f64 KKT residual certifies 1
            status_base = jnp.where(
                infeas32, jnp.int32(-3),
                jnp.where(bad <= KKT_TOL, jnp.int32(1), jnp.int32(-1)))
            out = Solution(U, lam, act, side, fval, iters, status_base)
            # f64 re-solves are COLD, with doubled slot capacity (covers
            # overflow lanes): warm-starting them from the f32 bulk state
            # re-litigates the f32 working set at sign_tol=1e-11 in long
            # blocking cascades
            s2 = min(m_c, ((2 * s_max + 7) // 8) * 8)

            def resolve(out, idx, take):
                fix = _f64_resolve(hi, du_h[idx], dl_h[idx], th64[idx], s2,
                                   bulk_cap_c + 24)
                fix = fix._replace(iters=out.iters[idx] + fix.iters)
                return _merge_top(out, fix, idx, take)

            # a sample of the f32 ray verdicts gets an f64 verdict
            k_b = min(max(128, B // 64), B)
            flag_b, idx_b = jax.lax.top_k(infeas32.astype(jnp.int32), k_b)
            out = resolve(out, idx_b, flag_b > 0)
            # every un-certified lane that f32 did not flag infeasible
            # (marginal or degenerate working sets, iteration-cap and
            # capacity exits) is re-solved in f64, worst first, in rounds
            # of K lanes -- as many rounds as there are such lanes
            K = min(256, B)
            pending = ~(bad <= KKT_TOL) & ~infeas32
            score = jnp.where(jnp.isnan(bad), jnp.inf, bad)

            def round_body(c):
                out, pending, r = c
                take, idx = jax.lax.top_k(jnp.where(pending, score, -jnp.inf), K)
                take = take > -jnp.inf
                return resolve(out, idx, take), pending.at[idx].set(False), r + 1

            out, _, _ = jax.lax.while_loop(
                lambda c: jnp.any(c[1]) & (c[2] < -(-B // K)), round_body,
                (out, pending, jnp.int32(0)))

            # last-resort guard ladder: the handful of lanes whose working
            # set exhausts even the doubled slot budget or its iteration
            # cap. Re-solve the worst still-unresolved lanes at escalating
            # slot budgets and iteration caps; each pass is ~16 lanes of
            # f64 slot loop and fires (under lax.cond) only when
            # unresolved lanes remain.
            guard_cfgs = []
            s3 = min(m_c, ((3 * s2 + 7) // 8) * 8)
            if s3 > s2:
                guard_cfgs.append((s3, 2 * bulk_cap_c + 48))
            s4 = min(m_c, max(((2 * s3 + 7) // 8) * 8, 128))
            if s4 > s3:
                guard_cfgs.append((s4, 4 * bulk_cap_c + 96))

            def make_tier(s_g, cap_g, k_g):
                def tier(out):
                    unres = out.status == -1
                    _, idx3 = jax.lax.top_k(jnp.where(unres, bad, -jnp.inf), k_g)
                    g = _f64_resolve(hi, du_h[idx3], dl_h[idx3], th64[idx3], s_g, cap_g)
                    g = g._replace(iters=out.iters[idx3] + g.iters)
                    return _merge_top(out, g, idx3, unres[idx3] & (g.status != -1))

                return tier

            for s_g, cap_g in guard_cfgs:
                out = jax.lax.cond(
                    jnp.any(out.status == -1),
                    make_tier(s_g, cap_g, min(16, B)),
                    lambda out: out, out)
            return out

        self._ciu_batched = jax.jit(_ciu_batch)

    # -- hybrid problems: branch-and-bound --------------------------------
    def _build_hybrid(self, kw):
        import os

        from .bnb import solve_bnb_single

        ldp = self.ldp
        nb = int(np.sum(ldp.is_binary))
        stack_cap = max(2 * nb + 2, 4)
        bnb_kw = {k: v for k, v in kw.items()
                  if k not in ("bulk_unroll", "bulk_inverse_updates")}
        bnb_kw.update(stack_cap=stack_cap, node_limit=self.bnb_node_limit)

        def _bnb(arrays, hi, theta):
            sol = solve_bnb_single(arrays, theta, **bnb_kw)
            if hi is None:
                return sol
            return polish_solution(
                hi, theta, sol.active, sol.side,
                use_cholesky=self.symmetric, iters=sol.iters, status=sol.status,
            )

        self._bnb = jax.jit(_bnb)
        self._bnb_batched = jax.jit(
            lambda arrays, hi, thetas: jax.vmap(lambda th: _bnb(arrays, hi, th))(thetas)
        )

        # batched node-frontier B&B (the production batched hybrid path):
        # one popped node per lane per round, the whole frontier of
        # relaxations solved as one vmapped XLA phase.
        # LINEARMPC_TPU_FRONTIER=0 restores the per-lane DFS.
        self.use_frontier = (
            os.environ.get("LINEARMPC_TPU_FRONTIER", "1") != "0" and self.symmetric
        )
        self.bulk_route = "frontier" if self.use_frontier else "dfs"
        if not self.use_frontier:
            return
        from .bnb_frontier import make_xla_relax, solve_bnb_frontier

        node_cap = min(self.iter_limit, 2 * ldp.m + 24)
        # beyond m ~ 64 the GI inverse-update node solver cycles /
        # fabricates dual rays on massively degenerate relaxations
        # (invpend_contact); the masked-Cholesky loop is the scheme that
        # converges there
        fr_mode = "cholesky" if ldp.m > 64 else "iu"
        fr_arrays = self.arrays
        fr_tols = dict(primal_tol=self.primal_tol, sign_tol=self.sign_tol)
        if (fr_mode == "cholesky" and self.dtype == jnp.float32
                and self.arrays_hi is not None):
            # the f32 Cholesky ridge (~100 m eps32 ~ 3e-3 at m=250) cannot
            # resolve the massively dual-degenerate relaxations (170
            # active rows vs rank 70 on invpend_contact's root), so every
            # node would fail _primal_feasible: run the node relaxations
            # (and the whole frontier state) in f64
            fr_arrays = self.arrays_hi
            fr_tols = dict(primal_tol=min(self.primal_tol, 1e-6), sign_tol=1e-11)
        fr_relax = make_xla_relax(fr_arrays, max_iter=node_cap, mode=fr_mode, **fr_tols)
        self._frontier_batched = jax.jit(
            lambda arrays, hi, ths: solve_bnb_frontier(
                fr_arrays, hi, ths, fr_relax,
                stack_cap=stack_cap,
                node_limit=self.bnb_node_limit,
                use_cholesky=self.symmetric, warm_nodes=True,
            )
        )

    # -- model parallelism: route batched solves through the mp-Schur
    # sharded solver (parallel/schur.py) when a device mesh is attached
    # and the row dimension exceeds the single-chip fast-path ceiling
    def attach_mesh(self, mesh, *, mp_threshold: int = 512, force: bool = False,
                    **schur_kw):
        """Configure a (dp, mp) mesh. Batched solves dispatch to the
        shard_map row-sharded CG solver when ``ldp.m > mp_threshold`` (or
        ``force``); smaller problems keep the single-chip kernels and can
        still be dp-sharded by the caller. Returns self."""
        self._mp_solver = None
        if self.has_binaries:
            # the mp-Schur solver solves the CONTINUOUS relaxation; routing
            # a hybrid engine through it would silently drop the binaries
            raise ValueError(
                "attach_mesh does not support hybrid (binary-constrained) "
                "problems: the mp-Schur solver has no branch-and-bound")
        if force or self.ldp.m > mp_threshold:
            from ..parallel.schur import make_mp_batch_solver

            self._mp_solver = make_mp_batch_solver(
                self.ldp, mesh,
                max_iter=min(self.iter_limit, 2 * self.ldp.m + 32),
                primal_tol=min(self.primal_tol, 1e-6),
                sign_tol=max(self.sign_tol, 1e-9), **schur_kw)
        return self

    # -- host-facing single solve (reference solve(), src/utils.jl:268-283)
    def solve(self, theta) -> tuple[np.ndarray, float, int, dict]:
        in_dtype = jnp.float64 if self.polish else self.dtype
        theta = jnp.asarray(np.asarray(theta, dtype=np.float64), dtype=in_dtype)
        if self.lex is not None:
            sol = self.lex.solve(theta)
        elif self.has_binaries:
            sol = self._bnb(self.arrays, self.arrays_hi, theta)
        else:
            sol = self._single(self.arrays, self.arrays_hi, theta)
        info = {
            "iterations": int(sol.iters),
            "lam": np.asarray(sol.lam),
            "active": np.asarray(sol.active),
            "side": np.asarray(sol.side),
        }
        return np.asarray(sol.U, dtype=np.float64), float(sol.fval), int(sol.status), info

    # -- device-facing batched solve
    def solve_batch(self, thetas, warm=None) -> Solution:
        # keep theta at full precision when polishing (downcast happens
        # inside the bulk phase only)
        in_dtype = jnp.float64 if self.polish else self.dtype
        thetas = jnp.asarray(thetas, dtype=in_dtype)
        w = (None,) * 3 if warm is None else tuple(warm)
        if self.lex is not None:
            return self.lex.solve_batch(thetas)
        if getattr(self, "_mp_solver", None) is not None:
            return self._mp_solver(thetas)
        if self.bulk_route == "frontier":
            return self._frontier_batched(self.arrays, self.arrays_hi, thetas)
        if self.bulk_route == "dfs":
            return self._bnb_batched(self.arrays, self.arrays_hi, thetas)
        if self.bulk_route == "fused":
            return self._fused_batched(self.arrays_hi, thetas, *w)
        if self.bulk_route == "compact":
            return self._ciu_batched(self.arrays, self.arrays_hi, thetas, *w)
        return self._batched(self.arrays, self.arrays_hi, thetas, *w)
