"""Fused Pallas (Triton) kernel for the small-m bulk dual active-set phase.

The plain XLA path runs each solver iteration as a chain of small fusions
under a ``lax.while_loop`` whose predicate travels to the host every
iteration; at m ~ 5-10 a batch spends its time in launches and syncs, not
arithmetic. Here the WHOLE bulk loop -- working-set-inverse lookup,
multiplier solve, blocking test, violation scan, state update -- runs
inside one kernel launch: a 1-D grid over lane blocks, each block an
in-kernel ``lax.while_loop`` with its own early exit.

Every per-lane quantity is a Python list of m ``(BL,)`` vectors (one lane
per thread), so the iteration is pure elementwise arithmetic in registers:
no padding of the constraint dimension, no cross-thread reductions except
the block's exit test. The working-set inverse of the current active set
is read from the precomputed (2^m, m, m) subset-inverse table by indexed
loads (3.2 KB at m=5, L1/L2 resident). The problem's G, equality and
immutable masks are compile-time constants: zero entries of G and the
structurally impossible branches (sign tests on equality rows, candidate
tests on infinite rows) are dropped while tracing.

The iteration is exactly that of ``dual_active_set._active_set_loop`` with
a subset cache (same tie-breaking: first index of the min/max); only the
summation order of the two m-term products differs, so a rare f32
near-tie may resolve to an adjacent working set -- the engine's f64
finishing tiers re-check every lane.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PALLAS_MAX_M = 10
# lanes per program, one per thread: the kernel takes ~10 us of a ~0.4 ms
# host-bound batch at B=32768, so block shapes from 128 to 1024 lanes time
# the same on an H100
BLOCK_LANES = 128
NUM_WARPS = 4
_BIG = np.float32(1e30)  # the XLA loop's finite sentinel


def _bulk_kernel(tbl_ref, du_ref, dl_ref, lam_ref, act_ref, side_ref,
                 lam_o, act_o, side_o, iters_o, done_o, *,
                 m, BL, G, eq, immut, max_iter, primal_tol, sign_tol):
    f32 = jnp.float32
    big = _BIG
    ptol = np.float32(primal_tol)
    stol = np.float32(sign_tol)
    rows = range(m)
    lanes = pl.ds(pl.program_id(0) * BL, BL)
    du = [du_ref[lanes, i] for i in rows]
    dl = [dl_ref[lanes, i] for i in rows]
    lam0 = [lam_ref[lanes, i] for i in rows]
    act0 = [act_ref[lanes, i] for i in rows]
    side0 = [side_ref[lanes, i] for i in rows]
    done0 = jnp.zeros((BL,), jnp.int32)
    iters0 = jnp.zeros((BL,), jnp.int32)

    def cond(c):
        *_s, done, _iters, it = c
        return (it < max_iter) & (jnp.min(done) == 0)

    def body(c):
        lam, act, side, done, iters, it = c
        mask_id = jnp.zeros((BL,), jnp.int32)
        for i in rows:
            mask_id = mask_id + jnp.where(act[i], 1 << i, 0)
        base = mask_id * (m * m)
        rhs = [jnp.where(act[i], -jnp.where(side[i], du[i], dl[i]), np.float32(0))
               for i in rows]
        # lam* = subset_inv[mask] @ rhs, one indexed load per entry
        lam_star = []
        for i in rows:
            acc = jnp.zeros((BL,), f32)
            for j in rows:
                acc = acc + tbl_ref[base + (i * m + j)] * rhs[j]
            lam_star.append(acc)

        # blocking step: the first multiplier to cross zero leaves the set
        has_viol = jnp.zeros((BL,), bool)
        a_min = jnp.full((BL,), big, f32)
        jb = jnp.zeros((BL,), jnp.int32)
        for i in rows:
            if eq[i]:
                continue
            sv = act[i] & jnp.where(side[i], lam_star[i] < -stol, lam_star[i] > stol)
            has_viol = has_viol | sv
            den = lam[i] - lam_star[i]
            safe = jnp.where(jnp.abs(den) > np.float32(1e-30), den, np.float32(1e-30))
            a_i = jnp.where(sv, lam[i] / safe, big)
            better = a_i < a_min
            a_min = jnp.where(better, a_i, a_min)
            jb = jnp.where(better, i, jb)
        alpha = jnp.clip(a_min, np.float32(0), np.float32(1))

        # acceptance step: add the most violated inactive row
        v_max = jnp.full((BL,), -big, f32)
        jsel = jnp.zeros((BL,), jnp.int32)
        add_up = jnp.zeros((BL,), bool)
        for i in rows:
            if immut[i]:
                continue
            c_i = jnp.zeros((BL,), f32)
            for j in rows:
                if G[i][j] != 0.0:
                    c_i = c_i + np.float32(G[i][j]) * lam_star[j]
            cand = ~act[i]
            v_up = jnp.where(cand, -(du[i] + c_i), -big)
            v_lo = jnp.where(cand, dl[i] + c_i, -big)
            v = jnp.maximum(v_up, v_lo)
            better = v > v_max
            v_max = jnp.where(better, v, v_max)
            jsel = jnp.where(better, i, jsel)
            add_up = jnp.where(better, v_up >= v_lo, add_up)
        converged = v_max <= ptol
        live = done == 0

        n_lam, n_act, n_side = [], [], []
        for i in rows:
            lam_B = jnp.where(jb == i, np.float32(0),
                              lam[i] + alpha * (lam_star[i] - lam[i]))
            act_B = act[i] & (jb != i)
            grow = (jsel == i) & ~converged
            act_A = act[i] | grow
            side_A = jnp.where(grow, add_up, side[i])
            lam_A = jnp.where(act_A, lam_star[i], np.float32(0))
            upd = live
            n_lam.append(jnp.where(upd, jnp.where(has_viol, lam_B, lam_A), lam[i]))
            n_act.append(jnp.where(upd, jnp.where(has_viol, act_B, act_A), act[i]))
            n_side.append(jnp.where(upd & ~has_viol, side_A, side[i]))
        fin = live & ~has_viol & converged
        done = jnp.where(fin, 1, done)
        iters = iters + jnp.where(live, 1, 0)
        return n_lam, n_act, n_side, done, iters, it + 1

    lam, act, side, done, iters, _ = jax.lax.while_loop(
        cond, body, (lam0, act0, side0, done0, iters0, jnp.int32(0)))
    for i in rows:
        lam_o[lanes, i] = lam[i]
        act_o[lanes, i] = act[i]
        side_o[lanes, i] = side[i]
    iters_o[lanes] = iters
    done_o[lanes] = done > 0


def make_bulk_phase(subset_inv, G, is_eq, is_immutable, *, max_iter: int,
                    primal_tol: float, sign_tol: float, interpret: bool = False):
    """Build the fused bulk phase for one problem.

    Returns ``bulk(du_t, dl_t, lam0, act0, side0) -> (lam, act, side,
    iters, done)``, all batch-major: ``du_t``/``dl_t``/``lam0`` (B, m)
    f32, ``act0``/``side0`` (B, m) bool. Any B: a batch that is not a
    multiple of ``BLOCK_LANES`` is padded by repeating lane 0 and sliced
    back. ``interpret=True`` runs the kernel body
    through the Pallas interpreter (CPU tests); otherwise it is compiled
    by Triton for the GPU.
    """
    subset_inv = np.asarray(subset_inv, np.float64)
    m = subset_inv.shape[1]
    if not 0 < m <= PALLAS_MAX_M:
        raise ValueError(f"fused bulk kernel supports 0 < m <= {PALLAS_MAX_M}, got {m}")
    tbl = jnp.asarray(subset_inv.reshape(-1), jnp.float32)
    statics = dict(
        m=m, BL=BLOCK_LANES,
        G=tuple(tuple(float(x) for x in row) for row in np.asarray(G, np.float64)),
        eq=tuple(bool(x) for x in np.asarray(is_eq)),
        immut=tuple(bool(x) for x in np.asarray(is_immutable)),
        max_iter=int(max_iter), primal_tol=float(primal_tol),
        sign_tol=float(sign_tol))
    BL = BLOCK_LANES

    @jax.jit
    def bulk(du_t, dl_t, lam0, act0, side0):
        B = du_t.shape[0]
        Bp = -(-B // BL) * BL

        def prep(a, dtype):
            a = a.astype(dtype)
            if Bp > B:
                a = jnp.concatenate([a, jnp.repeat(a[:1], Bp - B, axis=0)])
            return a

        state = jax.ShapeDtypeStruct((Bp, m), jnp.float32)
        flags = jax.ShapeDtypeStruct((Bp, m), jnp.bool_)
        outs = pl.pallas_call(
            functools.partial(_bulk_kernel, **statics),
            grid=(Bp // BL,),
            out_shape=[state, flags, flags,
                       jax.ShapeDtypeStruct((Bp,), jnp.int32),
                       jax.ShapeDtypeStruct((Bp,), jnp.bool_)],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
            interpret=interpret,
            name="lmpc_bulk_small_m",
        )(tbl, prep(du_t, jnp.float32), prep(dl_t, jnp.float32),
          prep(lam0, jnp.float32), prep(act0, bool), prep(side0, bool))
        return tuple(o[:B] for o in outs)

    return bulk
