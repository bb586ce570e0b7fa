"""Distributed (dp x mp) KKT-sharded solver vs the NumPy f64 reference on
the virtual 8-device CPU mesh (SURVEY.md section 2.3 model-parallel plan)."""

import numpy as np

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy
from linearmpc_tpu.parallel.mesh import make_mesh
from linearmpc_tpu.parallel.schur import make_mp_batch_solver


def _large_m_mpc():
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, 12))
    mpc.setup()
    return mpc


def test_engine_attach_mesh_routes_to_schur():
    """Engine-level routing: after ``attach_mesh`` the
    SAME ``solve_batch`` entry dispatches to the mp-Schur solver and
    agrees with the single-chip path."""
    mpc = _large_m_mpc()
    e = mpc.engine
    rng = np.random.default_rng(3)
    B = 16
    thetas = np.hstack([
        rng.uniform(-10, 10, (B, 4)), rng.uniform(-10, 10, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    sol_single = e.solve_batch(thetas)

    mesh = make_mesh(dp=4, mp=2)
    # below the default mp_threshold nothing changes
    e.attach_mesh(mesh)
    assert e._mp_solver is None
    e.attach_mesh(mesh, force=True)
    assert e._mp_solver is not None
    sol_mp = e.solve_batch(thetas)
    ok = (np.asarray(sol_mp.status) == 1) & (np.asarray(sol_single.status) == 1)
    assert np.mean(ok) > 0.8
    assert np.max(np.abs(np.asarray(sol_mp.U)[ok]
                         - np.asarray(sol_single.U)[ok])) < 1e-7


def test_mp_sharded_solver_matches_reference():
    mpc = _large_m_mpc()
    ldp = mpc.engine.ldp
    assert ldp.m > 12  # beyond the subset cache: the path mp targets

    mesh = make_mesh(dp=2, mp=4)
    solve = make_mp_batch_solver(ldp, mesh)

    rng = np.random.default_rng(0)
    B = 32
    thetas = np.hstack([
        rng.uniform(-12, 12, (B, 4)), rng.uniform(-12, 12, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    sol = solve(thetas)
    U = np.asarray(sol.U)
    status = np.asarray(sol.status)
    n_checked = 0
    for i in range(B):
        Ur, lam_r, work, it, s = solve_ldp_numpy(ldp, thetas[i])
        if s == 1:
            # feasible instances must converge and match the reference
            assert status[i] == 1, i
            assert np.max(np.abs(U[i] - Ur)) < 1e-8, i
            n_checked += 1
        # reference-failed lanes are skipped: the sequential reference has
        # no anti-cycling rule and stalls on degenerate vertices that the
        # batched solver handles (and truly infeasible draws are reported
        # as status -1 by both)
    assert n_checked >= B // 2
    # some lanes must actually hit the added state constraints for the
    # masked CG solve to be exercised beyond the trivial working set
    assert np.asarray(sol.active).any()


def test_mp_solver_pads_rows_to_mp_multiple():
    mpc = _large_m_mpc()
    ldp = mpc.engine.ldp
    mesh = make_mesh(dp=1, mp=8)  # forces padding unless m % 8 == 0
    solve = make_mp_batch_solver(ldp, mesh)
    rng = np.random.default_rng(1)
    thetas = np.hstack([
        rng.uniform(-10, 10, (8, 4)), rng.uniform(-10, 10, (8, 2)),
        rng.uniform(-1, 1, (8, 1)),
    ])
    sol = solve(thetas)
    assert np.asarray(sol.lam).shape == (8, ldp.m)  # padding stripped
    for i in range(8):
        Ur, *_r, s = solve_ldp_numpy(ldp, thetas[i])
        if s == 1:
            assert np.max(np.abs(np.asarray(sol.U)[i] - Ur)) < 1e-8
