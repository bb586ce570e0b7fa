"""Fused batched closed-loop rollout: the accelerator production path.

The reference's serial simulation loop (src/simulation.jl:93-113) becomes a
``lax.scan`` over time with every per-step stage fused into one jitted
program -- measure, Kalman correct, parameter assembly, warm-started dual
active-set solve, Kalman predict, plant step -- and ``vmap``ed over
thousands of scenario lanes per chip (SURVEY.md section 2.3 data-parallel
plan). Warm starts carry the working set between steps, matching DAQP's
warm-start semantics (reference codegen DAQP_WARMSTART,
src/codegen.jl:167-169).

Supports the full parameter layout theta = [x; r; d; u_prev; p] including
reference/disturbance/parameter preview (sliding hold-last windows sliced
per step with ``dynamic_slice``), reference condensation, and offset-free
observers (the augmented estimator state rides in the scan carry; its
estimated disturbance channels are merged into theta exactly like
``get_control_disturbance``, reference src/observer.jl:203-225).
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .condense import get_affine_parameter_base_dim
from .ops.dual_active_set import solve_single


class RolloutResult(NamedTuple):
    xs: jax.Array      # (B, N, nx) plant states
    us: jax.Array      # (B, N, nu) applied controls
    ys: jax.Array      # (B, N, ny) outputs
    iters: jax.Array   # (B, N) solver iterations per step
    status: jax.Array  # (B, N)


def _pad_traj_time(traj, T_needed):
    """Hold-last pad a (B, T, n) trajectory along time to T_needed."""
    B, T, n = traj.shape
    if T >= T_needed:
        return traj[:, :T_needed, :]
    pad = jnp.broadcast_to(traj[:, -1:, :], (B, T_needed - T, n))
    return jnp.concatenate([traj, pad], axis=1)


def build_rollout(mpc, *, plant=None, use_observer=None, polish=None):
    """Compile a batched closed-loop rollout for ``mpc``.

    Returns ``rollout(x0s, rs, ds, ps=None, N=100) -> RolloutResult``:
      * ``x0s``: (B, nx) initial states
      * ``rs``:  (B, ny) constant reference per lane or (B, T, ny) trajectory
      * ``ds``:  (B, T, nd_measured) measured disturbances (or None)
      * ``ps``:  (B, np_base) constant or (B, T, np_base) trajectory (or None)
    ``N`` is static (baked into the scan length at first call).

    ``plant``: optional (F, G, f_offset)-triple overriding the simulated
    plant (defaults to the controller model, like ``scenario.dynamics``).
    """
    if not mpc.mpqp_issetup:
        mpc.setup()

    engine = mpc.engine
    arrays = engine.arrays
    arrays_hi = engine.arrays_hi if (polish is None or polish) else None
    kw = dict(engine._solve_kw)
    # with f64 finishing the closed loop (plant, observer, controls) runs
    # in f64 too; f32 is the solver's bulk-phase precision only
    dtype = jnp.float64 if arrays_hi is not None else engine.dtype
    dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)

    model = mpc.model
    nx, nu, ny, nd_model = model.nx, model.nu, model.ny, model.nd
    nx_, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    Np = mpc.Np
    np_base = get_affine_parameter_base_dim(mpc)

    r_preview = mpc.settings.reference_preview and nr > 0
    r_condense = r_preview and mpc.settings.reference_condensation
    d_preview = mpc.settings.disturbance_preview and nd > 0
    p_preview = mpc.settings.parameter_preview and np_ > 0

    obs = mpc.state_observer
    has_obs = obs is not None if use_observer is None else bool(use_observer)
    offset_free = has_obs and hasattr(obs, "estimator")
    # offset-free: the simulated world (plant, measurement, ds input) sees
    # only the measured disturbance channels; the estimated channels come
    # from the augmented observer state (reference src/simulation.jl:87,
    # src/observer.jl:203-225)
    ndo = obs.nd_offsetfree if offset_free else 0
    nd_sim = obs.nd_measured if offset_free else nd_model

    c = lambda a: jnp.asarray(np.asarray(a, dtype=np.float64), dtype=dtype)
    if plant is None:
        Fp, Gp, fp = c(model.F), c(model.G), c(model.f_offset)
    else:
        Fp, Gp, fp = (c(a) for a in plant)
    Gd = c(model.Gd[:, :nd_sim])
    C = c(obs.C) if offset_free else c(model.C)
    Dd = c(obs.Dd) if offset_free else c(model.Dd)
    h_off = c(obs.h_offset) if offset_free else c(model.h_offset)
    K = c(mpc.K)
    T2S = c(mpc.traj2setpoint) if r_condense else None

    if has_obs:
        est = obs.estimator if offset_free else obs
        oF, oG, oGd = c(est.F), c(est.G), c(est.Gd)
        oC, oDd, oh = c(est.C), c(est.Dd), c(est.h_offset)
        of = c(est.f_offset)
        oK = c(est.K)
        nxo = est.F.shape[0]
    else:
        nxo = 0

    m = arrays.G.shape[0]
    # small m on a GPU: the fused bulk kernel + f64 finishing per scan step
    fused_solve = getattr(engine, "fused_rollout_solve", None)
    if arrays_hi is None:
        fused_solve = None

    def rollout(x0s, rs=None, ds=None, ps=None, N: int = 100):
        B = x0s.shape[0]
        x0s = jnp.asarray(x0s, dtype)

        # normalize trajectories to (B, N + Np + 1, *) with hold-last padding
        T_need = N + Np + 1
        if nr and rs is not None:
            rs = jnp.asarray(rs, dtype)
            if rs.ndim == 2:
                rs = rs[:, None, :]
            rs = _pad_traj_time(rs, T_need)
        else:
            rs = jnp.zeros((B, T_need, ny), dtype)
        if nd_sim and ds is not None:
            ds = jnp.asarray(ds, dtype)
            if ds.ndim == 2:
                ds = ds[:, None, :]
            ds = _pad_traj_time(ds, T_need)
        else:
            ds = jnp.zeros((B, T_need, nd_sim), dtype)
        if np_ and ps is not None:
            ps = jnp.asarray(ps, dtype)
            if ps.ndim == 2:
                ps = ps[:, None, :]
            ps = _pad_traj_time(ps, T_need)
        else:
            ps = jnp.zeros((B, T_need, max(np_base, 1)), dtype)

        def window(traj, k0, width):
            # time-major (B, width, n) blocks; callers flatten to match vec()
            return jax.lax.dynamic_slice_in_dim(traj, k0, width, axis=1)

        def step(carry, _):
            x, xo, uprev, lam, act, side, kk = carry
            d_k = jax.lax.dynamic_slice_in_dim(ds, kk, 1, axis=1)[:, 0, :]

            y_m = dot(x, C.T) + h_off + (dot(d_k, Dd.T) if nd_sim else 0.0)

            if has_obs:
                inov = y_m - dot(xo, oC.T) - oh - (dot(d_k, oDd.T) if nd_sim else 0.0)
                xo = xo + dot(inov, oK.T)
                xhat = xo[:, :nx]
            else:
                xhat = x
            d_est = xo[:, nx : nx + ndo] if offset_free else None

            parts = [xhat]
            if nr:
                if r_preview:
                    # reference window: steps k+1 .. k+Np (hold-last)
                    r_flat = window(rs, kk + 1, Np).reshape(B, -1)
                    parts.append(dot(r_flat, T2S.T) if r_condense else r_flat)
                else:
                    parts.append(jax.lax.dynamic_slice_in_dim(rs, kk, 1, axis=1)[:, 0, :])
            if nd:
                if d_preview:
                    w = window(ds, kk, Np)
                    if ndo:
                        w = jnp.concatenate(
                            [w, jnp.broadcast_to(d_est[:, None, :], (B, Np, ndo))], axis=2
                        )
                    parts.append(w.reshape(B, -1))
                else:
                    parts.append(jnp.concatenate([d_k, d_est], axis=1) if ndo else d_k)
            if nuprev:
                parts.append(uprev[:, :nuprev])
            if np_:
                if p_preview:
                    parts.append(window(ps, kk, Np).reshape(B, -1))
                else:
                    parts.append(jax.lax.dynamic_slice_in_dim(ps, kk, 1, axis=1)[:, 0, :])
            theta = jnp.concatenate(parts, axis=1)

            if fused_solve is not None:
                U, sol_lam, sol_active, sol_side, iters_n, status_n = fused_solve(
                    theta, lam, act, side)
            else:
                sol = jax.vmap(
                    lambda th, l0, a0, s0: solve_single(arrays, th, l0, a0, s0, ldp_hi=arrays_hi, **kw)
                )(theta, lam, act, side)
                U, sol_lam, sol_active, sol_side = sol.U, sol.lam, sol.active, sol.side
                iters_n, status_n = sol.iters, sol.status
            u = U[:, :nu].astype(dtype) - dot(xhat, K.T)

            if has_obs:
                xo = dot(xo, oF.T) + dot(u, oG.T) + of + (dot(d_k, oGd.T) if nd_sim else 0.0)

            x_next = dot(x, Fp.T) + dot(u, Gp.T) + fp + (dot(d_k, Gd.T) if nd_sim else 0.0)
            carry = (x_next, xo, u, sol_lam.astype(dtype), sol_active, sol_side, kk + 1)
            return carry, (x, u, y_m, iters_n, status_n)

        xo0 = jnp.zeros((B, nxo), dtype)
        if has_obs:
            xo0 = xo0.at[:, :nx].set(x0s)
        carry0 = (
            x0s, xo0, jnp.zeros((B, nu), dtype),
            jnp.zeros((B, m), dtype), jnp.zeros((B, m), dtype=bool),
            jnp.ones((B, m), dtype=bool), jnp.int32(0),
        )
        carry, (xs, us, ys, iters, status) = jax.lax.scan(step, carry0, None, length=N)
        return RolloutResult(
            jnp.moveaxis(xs, 0, 1), jnp.moveaxis(us, 0, 1), jnp.moveaxis(ys, 0, 1),
            jnp.moveaxis(iters, 0, 1), jnp.moveaxis(status, 0, 1),
        )

    return jax.jit(rollout, static_argnames=("N",))
