"""Batched dense LP solver (primal-dual interior point) — the batched
feasibility oracle for explicit-MPC enumeration and certification.

The reference's offline analyses (ParametricDAQP region enumeration,
ASCertain certification — SURVEY.md rows 15-16) and our explicit.py solve
one small Chebyshev LP per candidate region through scipy/HiGHS: a serial
host bottleneck once enumerations reach thousands of candidates. Here the
whole frontier of candidate polytopes is solved at once: one fixed-shape
primal-dual path-following iteration, ``vmap``-batched over lanes, with
the (n x n) normal-equations solve as a batched Cholesky — all device
work.

Signed Chebyshev formulation: maximize r s.t. A th + ||A_i|| r <= b plus
box rows — *without* r >= 0 — so every instance is strictly feasible
(push r below all slacks at the box center) and emptiness is simply
r* < 0. That removes the need for infeasibility detection inside the IPM:
primal feasibility is maintained exactly (A dx + ds = 0) from the strictly
feasible start.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_LP_DEVICE = None


def _lp_device():
    """Where the oracle runs. Default: the host CPU backend even when an
    accelerator is attached -- each offline wave is a tiny f64 LP batch
    (B <= a few hundred, m <= ~100, n <= ~10) where compilation and
    per-call dispatch dominate the actual Newton work.
    LINEARMPC_TPU_LP_DEVICE=accelerator opts large fleets onto the default
    accelerator (an error when JAX finds none); the math is
    backend-agnostic."""
    global _LP_DEVICE
    if _LP_DEVICE is None:
        pref = os.environ.get("LINEARMPC_TPU_LP_DEVICE", "cpu")
        if pref == "cpu":
            _LP_DEVICE = jax.devices("cpu")[0]
        elif pref == "accelerator":
            dev = jax.devices()[0]
            if dev.platform == "cpu":
                raise RuntimeError(
                    "LINEARMPC_TPU_LP_DEVICE=accelerator, but JAX found no accelerator")
            _LP_DEVICE = dev
        else:
            raise ValueError(
                f"LINEARMPC_TPU_LP_DEVICE must be 'cpu' or 'accelerator', got {pref!r}")
    return _LP_DEVICE


@partial(jax.jit, static_argnames=("n_iter",))
def lp_ipm_batch(A, b, c, x0, *, n_iter: int = 40):
    """Solve min c'x s.t. A x <= b for a batch of LPs.

    Args:
      A: (B, m, n); zero rows are valid padding when the matching b > 0.
      b: (B, m)
      c: (B, n) or (n,)
      x0: (B, n) strictly feasible starts (A x0 < b elementwise).
    Returns (x, obj, gap, rd): primal solutions, objectives, final
    complementarity gaps, and the final dual residual c + A'lam (B, n) --
    a certified objective bound must account for BOTH gap and rd
    (the IPM terminates on an iteration budget, not on rd).
    """
    B, m, n = A.shape
    dtype = A.dtype
    c = jnp.broadcast_to(c, (B, n)).astype(dtype)

    s0 = b - jnp.einsum("bmn,bn->bm", A, x0)
    lam0 = jnp.ones((B, m), dtype)

    eye = jnp.eye(n, dtype=dtype)

    def body(_, state):
        x, s, lam = state
        # s stays exactly primal-feasible: A dx + ds = 0 throughout
        s = jnp.maximum(s, 1e-14)                     # guard divisions
        d = lam / s                                   # (B, m)
        mu = jnp.mean(lam * s, axis=1, keepdims=True)
        sigma = jnp.asarray(0.2, dtype)
        r_d = c + jnp.einsum("bmn,bm->bn", A, lam)    # dual residual
        rhs = -r_d - jnp.einsum("bmn,bm->bn", A, sigma * mu / s - lam)
        # Newton system (A' D A) dx = rhs, solved through a batched QR of
        # W = sqrt(D) A instead of a Cholesky of the explicitly-formed
        # normal matrix: enumerated region descriptions routinely carry
        # near-duplicate rows, where the normal-equation Cholesky either
        # emits NaNs (tiny ridge) or, with a ridge big enough to survive,
        # converges to a visibly WRONG optimum that the duality gap cannot
        # see (observed: claimed radius -9.5e-6 for a region whose true
        # Chebyshev radius is +1.0e-5, gap 5e-17). QR keeps the working
        # conditioning at cond(W), and the appended sqrt(ridge) I rows --
        # ridge ~1e-13 of the matrix scale -- only guard exact rank
        # deficiency without biasing thin-region geometry.
        W = jnp.sqrt(d)[..., None] * A                # (B, m, n)
        tr = jnp.sum(W * W, axis=(1, 2), keepdims=True) / n
        W_aug = jnp.concatenate(
            [W, jnp.sqrt(1e-13 * tr + 1e-30) * eye[None, :, :]
             * jnp.ones((B, 1, 1), dtype)], axis=1)
        Rq = jnp.linalg.qr(W_aug, mode="r")           # (B, n, n)
        from jax.scipy.linalg import solve_triangular

        y = solve_triangular(
            jnp.swapaxes(Rq, -1, -2), rhs[..., None], lower=True)
        dx = solve_triangular(Rq, y, lower=False)[..., 0]
        ds = -jnp.einsum("bmn,bn->bm", A, dx)
        dlam = (sigma * mu - lam * (s + ds)) / s

        # fraction-to-boundary step
        def maxstep(v, dv):
            t = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
            return jnp.minimum(1.0, 0.995 * jnp.min(t, axis=1, keepdims=True))

        ap = maxstep(s, ds)
        ad = maxstep(lam, dlam)
        x = x + ap * dx
        s = s + ap * ds
        lam = lam + ad * dlam
        return x, s, lam

    x, s, lam = jax.lax.fori_loop(0, n_iter, body, (x0, s0, lam0))
    obj = jnp.sum(c * x, axis=1)
    gap = jnp.sum(lam * s, axis=1) / m
    rd = c + jnp.einsum("bmn,bm->bn", A, lam)
    return x, obj, gap, rd


def _pad_lp(A, b, x0, cs=None):
    """Bucket LP batches to cached jit shapes: rows to the next POWER OF
    TWO >= 32 (zero rows with rhs 2: never binding, slack 2 from any x),
    lanes to the next power of two >= 64 (lane 0 repeated), lanes capped
    by the caller's chunking. Enumeration calls the oracle once per BFS
    frontier, each with a different (B, m) -- without bucketing, XLA
    recompiles the IPM for every frontier and the compiles dominate the
    whole offline analysis. Returns the padded arrays and the
    true B to slice back. Certified-slack callers must use the PADDED
    row count (padding rows' complementarity products only loosen the
    bound -- still sound)."""
    B, m, n = A.shape
    m_pad = 32
    while m_pad < m:
        m_pad *= 2
    # lane floor 256: tiny frontiers are cheap to over-pad, and a floor
    # this high keeps the whole enumeration on ~one compiled shape
    # (compiles dominated the invpend enumeration wall otherwise)
    B_pad = 256
    while B_pad < B:
        B_pad *= 2
    if m_pad > m:
        A = np.concatenate([A, np.zeros((B, m_pad - m, n))], axis=1)
        b = np.concatenate([b, 2.0 * np.ones((B, m_pad - m))], axis=1)
    if B_pad > B:
        rep = lambda a: np.concatenate(
            [a, np.broadcast_to(a[0], (B_pad - B,) + a.shape[1:])], axis=0)
        A, b, x0 = rep(A), rep(b), rep(x0)
        if cs is not None and np.ndim(cs) > 1:
            cs = rep(np.asarray(cs))
    return A, b, x0, cs, B


# lane cap per IPM dispatch; candidate batches are chunked (sorted by
# their true row count first, so one deep candidate does not force the
# whole wave onto the fattest row bucket)
_LP_CHUNK = 1024

# chunks at or below this lane count run the NumPy twin of the IPM:
# at enumeration scale (a few hundred tiny f64 LPs) the XLA compile of
# the jitted path costs more than the entire Newton work, and small
# problems never amortize it (measured: the whole invpend default-range
# enumeration is ~0.2 s of host math vs ~1 s of one-bucket XLA compile)
_LP_NUMPY_MAX = int(os.environ.get("LINEARMPC_TPU_LP_NUMPY_MAX", "256"))


def _ipm_numpy(A, b, c, x0, n_iter):
    """NumPy twin of ``lp_ipm_batch`` (same iteration, same QR-of-
    sqrt(D)A Newton solve); returns (x, obj, gap, rd)."""
    B, m, n = A.shape
    c = np.broadcast_to(c, (B, n))
    x = x0.copy()
    s = b - np.einsum("bmn,bn->bm", A, x0)
    lam = np.ones((B, m))
    eye = np.eye(n)
    for _ in range(n_iter):
        s = np.maximum(s, 1e-14)
        d = lam / s
        mu = np.mean(lam * s, axis=1, keepdims=True)
        sigma = 0.2
        r_d = c + np.einsum("bmn,bm->bn", A, lam)
        rhs = -r_d - np.einsum("bmn,bm->bn", A, sigma * mu / s - lam)
        W = np.sqrt(d)[..., None] * A
        tr = np.sum(W * W, axis=(1, 2), keepdims=True) / n
        W_aug = np.concatenate(
            [W, np.sqrt(1e-13 * tr + 1e-30) * eye[None, :, :]
             * np.ones((B, 1, 1))], axis=1)
        Rq = np.linalg.qr(W_aug, mode="r")
        # R'R dx = rhs via two tiny triangular systems (n <= ~10: a
        # generic batched solve is exact and cheap)
        z = np.linalg.solve(np.swapaxes(Rq, -1, -2), rhs[..., None])
        dx = np.linalg.solve(Rq, z)[..., 0]
        ds = -np.einsum("bmn,bn->bm", A, dx)
        dlam = (sigma * mu - lam * (s + ds)) / s

        def maxstep(v, dv):
            t = np.where(dv < 0, -v / np.where(dv < 0, dv, -1.0), np.inf)
            return np.minimum(1.0, 0.995 * np.min(t, axis=1, keepdims=True))

        ap = maxstep(s, ds)
        ad = maxstep(lam, dlam)
        x = x + ap * dx
        s = s + ap * ds
        lam = lam + ad * dlam
    obj = np.sum(c * x, axis=1)
    gap = np.sum(lam * s, axis=1) / m
    rd = c + np.einsum("bmn,bm->bn", A, lam)
    return x, obj, gap, rd


def _run_ipm(A, b, cs, x0, n_iter):
    """Dispatch one UNPADDED chunk to the NumPy twin (small batches: no
    shape bucketing, no compile) or to the padded jitted backend path
    (large batches), returning numpy (x, obj, gap, rd, m_padded) sliced
    to the true lane count. ``m_padded`` is the row count the gap was
    computed over (certificates must use it)."""
    B = A.shape[0]
    if B <= _LP_NUMPY_MAX:
        x, obj, gap, rd = _ipm_numpy(
            np.asarray(A, np.float64), np.asarray(b, np.float64),
            np.broadcast_to(np.asarray(cs, np.float64), (B, A.shape[2])),
            np.asarray(x0, np.float64), n_iter)
        return x, obj, gap, rd, A.shape[1]
    Ap, bp, x0p, csp, Bt = _pad_lp(A, b, np.asarray(x0, np.float64),
                                   np.broadcast_to(np.asarray(cs, np.float64),
                                                   (B, A.shape[2])))
    dev = _lp_device()
    put = lambda a: jax.device_put(jnp.asarray(a, dtype=jnp.float64), dev)
    x, obj, gap, rd = lp_ipm_batch(put(Ap), put(bp), put(csp), put(x0p),
                                   n_iter=n_iter)
    return (np.asarray(x)[:Bt], np.asarray(obj)[:Bt], np.asarray(gap)[:Bt],
            np.asarray(rd)[:Bt], Ap.shape[1])


def _row_sorted_chunks(As, bs):
    """Yield (index_array, m_trunc) chunks of <= _LP_CHUNK lanes, sorted
    by true (non-padding) row count so each chunk can be truncated to its
    own power-of-two row bucket. Rows are built front-packed by every
    caller; padding rows have zero norm."""
    B, m, _ = As.shape
    used = (np.linalg.norm(As, axis=2) > 1e-12).sum(axis=1)
    order = np.argsort(used, kind="stable")
    for i0 in range(0, B, _LP_CHUNK):
        idx = order[i0 : i0 + _LP_CHUNK]
        m_t = max(32, int(used[idx].max()) if len(idx) else 32)
        yield idx, min(m, m_t)


def support_batch(As, bs, lb, ub, cs, x0, *, n_iter: int = 45):
    """Batched support LP: min c'th over {A th <= b} ∩ [lb, ub].

    Args:
      As: (B, m, nth) rows with zero-row padding (matching bs >= 1);
      bs: (B, m);
      lb, ub: (nth,) box;
      cs: (B, nth) per-lane objectives;
      x0: (B, nth) strictly interior starts (e.g. Chebyshev centers).
    Returns (val, slack_tot, gap): primal objective values (an upper bound
    on the true minimum; the certified lower bound is ``val - slack_tot``).
    ``slack_tot`` covers the full duality error: the complementarity term
    m_total * gap PLUS the dual-residual term sum_i |rd_i| * max(|lb|,|ub|)_i
    (|rd' th| over the box; the IPM never checks rd at termination, so
    complementarity alone is not a certificate). Lanes
    whose start is not strictly interior or whose gap stays large must be
    routed to an exact host LP.
    """
    As = np.asarray(As, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64)
    B, m, nth = As.shape
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    cs = np.broadcast_to(np.asarray(cs, np.float64), (B, nth))
    x0 = np.asarray(x0, np.float64)

    box_A = np.zeros((2 * nth, nth))
    box_b = np.zeros(2 * nth)
    for i in range(nth):
        box_A[2 * i, i] = 1.0
        box_b[2 * i] = ub[i]
        box_A[2 * i + 1, i] = -1.0
        box_b[2 * i + 1] = -lb[i]
    box_mag = np.maximum(np.abs(lb), np.abs(ub))       # (nth,)

    val = np.zeros(B)
    slack_tot = np.zeros(B)
    gap_out = np.zeros(B)
    for idx, m_t in _row_sorted_chunks(As, bs):
        Bc = len(idx)
        A = np.concatenate(
            [As[idx, :m_t], np.broadcast_to(box_A, (Bc, 2 * nth, nth))], axis=1)
        b = np.concatenate([bs[idx, :m_t],
                            np.broadcast_to(box_b, (Bc, 2 * nth))], axis=1)
        x, obj, gap, rd, m_total = _run_ipm(A, b, cs[idx], x0[idx], n_iter)
        val[idx] = obj
        slack_tot[idx] = m_total * gap + (np.abs(rd) @ box_mag)
        gap_out[idx] = gap
    return val, slack_tot, gap_out


def chebyshev_batch(As, bs, lb, ub, *, n_iter: int = 45):
    """Batched signed Chebyshev radius of {A th <= b} ∩ [lb, ub].

    Args:
      As: (B, m, nth) region rows, zero rows as padding;
      bs: (B, m) with padding rows' rhs >= 1;
      lb, ub: (nth,) parameter box.
    Returns (r, center, gap): per-lane signed inscribed-ball radius over
    the box (negative => empty intersection), the ball center (valid when
    r > 0), and the final IPM complementarity gap. A stalled lane
    (degenerate near-parallel rows collapse the fraction-to-boundary step)
    can report a finite r that is far from optimal with a large gap --
    callers must route lanes with ``gap`` above ~1e-9 to an exact host LP
    before trusting r. Runs wherever jax runs (f64).
    """
    As = np.asarray(As, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64)
    B, m, nth = As.shape
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)

    # LP rows over x = [th; r]
    box_A = np.zeros((2 * nth, nth + 1))
    box_b = np.zeros(2 * nth)
    for i in range(nth):
        box_A[2 * i, i], box_A[2 * i, nth] = 1.0, 1.0
        box_b[2 * i] = ub[i]
        box_A[2 * i + 1, i], box_A[2 * i + 1, nth] = -1.0, 1.0
        box_b[2 * i + 1] = -lb[i]
    c = np.zeros(nth + 1)
    c[nth] = -1.0  # maximize r
    center = (lb + ub) / 2
    r_box = np.min((ub - lb) / 2)

    r_out = np.zeros(B)
    cen_out = np.zeros((B, nth))
    gap_out = np.zeros(B)
    for idx, m_t in _row_sorted_chunks(As, bs):
        Bc = len(idx)
        As_c, bs_c = As[idx, :m_t], bs[idx, :m_t]
        norms = np.linalg.norm(As_c, axis=2)          # (Bc, m_t)
        A = np.concatenate(
            [np.concatenate([As_c, norms[..., None]], axis=2),
             np.broadcast_to(box_A, (Bc, 2 * nth, nth + 1))], axis=1)
        b = np.concatenate([bs_c, np.broadcast_to(box_b, (Bc, 2 * nth))],
                           axis=1)
        # strictly feasible start: box center, r below every slack
        slack0 = bs_c - As_c @ center
        coef = np.where(norms > 1e-12, norms, 1.0)
        r_cand = np.where(norms > 1e-12, slack0 / coef, np.inf)
        r0 = np.minimum(np.min(r_cand, axis=1, initial=np.inf), r_box) - 1.0
        x0 = np.concatenate(
            [np.broadcast_to(center, (Bc, nth)), r0[:, None]], axis=1)
        x, obj, gap, rd, _mt = _run_ipm(A, b, c, x0, n_iter)
        r_out[idx] = x[:, nth]
        cen_out[idx] = x[:, :nth]
        # fold the dual residual into the reported gap so caller
        # thresholds (route-to-host-LP above ~1e-9) see both failures
        gap_out[idx] = gap + np.max(np.abs(rd), axis=1)
    return r_out, cen_out, gap_out
