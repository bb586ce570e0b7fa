"""Engine-level tests of the compact route at m = 48 (invpend Np=30, Nc=8
with a state box over ks 2..11): the f32 compact working-set bulk phase
(ops/compact_iu.py) and its f64 finishing and guard tiers, against the
NumPy f64 oracle and an exact LP feasibility certificate."""

import jax.numpy as jnp
import numpy as np
import pytest

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy


def _mpc_m48():
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, 12))
    mpc.setup(dtype=jnp.float32)
    assert mpc.engine.ldp.m == 48 and mpc.engine.bulk_route == "compact"
    return mpc


def _thetas(B, lo=8.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.hstack([
        rng.uniform(-lo, lo, (B, 4)), rng.uniform(-lo, lo, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])


@pytest.mark.parametrize("seed", [0, 13])
def test_compact_engine_matches_oracle(seed):
    e = _mpc_m48().engine
    thetas = _thetas(128, seed=seed)
    sol = e.solve_batch(thetas)
    status = np.asarray(sol.status)
    U = np.asarray(sol.U, np.float64)
    n_ok = 0
    for i in range(thetas.shape[0]):
        U_ref, *_r, s_ref = solve_ldp_numpy(e.ldp, thetas[i])
        if s_ref == 1:
            n_ok += 1
            assert status[i] == 1, f"lane {i}: engine {status[i]} vs oracle feasible"
            assert np.max(np.abs(U[i] - U_ref)) < 1e-8, i
        elif s_ref == -3:
            assert status[i] == -3, i
    assert n_ok >= 100  # the sampling box is mostly feasible


def test_compact_engine_infeasible_detection():
    """Far-out states make the state-constrained problem primal
    infeasible; the dual-unbounded-ray exit must flag them."""
    e = _mpc_m48().engine
    thetas = _thetas(128, lo=40.0, seed=3)
    status = np.asarray(e.solve_batch(thetas).status)
    for i in range(0, 128, 4):
        _U, *_r, s_ref = solve_ldp_numpy(e.ldp, thetas[i])
        if s_ref == -3:
            assert status[i] == -3, i
        elif s_ref == 1:
            assert status[i] == 1, i


def test_compact_engine_warm_start():
    """Warm starts land on the same solutions in no more iterations."""
    e = _mpc_m48().engine
    thetas = _thetas(128, seed=7)
    cold = e.solve_batch(thetas)
    warm = e.solve_batch(thetas, warm=(cold.lam, cold.active, cold.side))
    ok = np.asarray(cold.status) == 1
    assert np.max(np.abs(np.asarray(warm.U)[ok] - np.asarray(cold.U)[ok])) < 1e-8
    assert np.mean(np.asarray(warm.iters)[ok] <= np.asarray(cold.iters)[ok]) > 0.9


def test_ciu_engine_infeasibility_verdicts():
    """Wide-box batch with a real mix of feasible and infeasible lanes:
    every oracle-feasible lane must come back optimal (never a false -3),
    and every engine infeasibility verdict must be certified by an exact
    LP (a lane passing the f64 KKT residual has an exhibited feasible
    point, so a false 1 is impossible by construction -- pin it anyway)."""
    from scipy.optimize import linprog

    e = _mpc_m48().engine
    ldp = e.ldp
    thetas = _thetas(128, lo=16.0, seed=77)
    st = np.asarray(e.solve_batch(thetas).status)
    # exact primal feasibility oracle (HiGHS): the normalized constraint
    # rows in U-space are E_n = HinvET' H (hard rows only)
    E_n = ldp.HinvET.T @ ldp.H
    hard = ~ldp.is_immutable & ~ldp.is_soft

    def feasible(theta):
        du_t = ldp.du + ldp.Dth @ theta
        dl_t = ldp.dl + ldp.Dth @ theta
        A = np.vstack([E_n[hard], -E_n[hard]])
        b = np.concatenate([du_t[hard], -dl_t[hard]])
        keep = b < 1e19
        res = linprog(np.zeros(E_n.shape[1]), A_ub=A[keep], b_ub=b[keep],
                      bounds=[(None, None)] * E_n.shape[1], method="highs")
        return res.status == 0

    n_feas = n_inf = 0
    for i in range(128):
        _U, *_r, s_ref = solve_ldp_numpy(ldp, thetas[i])
        if s_ref == 1:
            n_feas += 1
            assert st[i] == 1, (i, st[i])
        elif st[i] == -3:
            n_inf += 1
            assert not feasible(thetas[i]), i
    assert n_feas >= 30 and n_inf >= 10  # the box really is mixed
