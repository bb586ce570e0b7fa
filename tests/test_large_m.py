"""Coverage for the masked-Cholesky solver path (m > subset-cache limit)
and the crazyflie stress example (prestab + terminal cost, 12 states)."""

import numpy as np

import linearmpc_tpu as lmpc
from linearmpc_tpu.mpc import MPC
from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy


def test_large_m_cholesky_path_matches_reference():
    """invpend with state constraints: m exceeds the working-set cache, so
    the batched masked-Cholesky path runs; differential vs NumPy."""
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, 12))
    mpc.setup()
    assert mpc.engine.ldp.m > 12
    assert mpc.engine._subset_inv is None

    rng = np.random.default_rng(0)
    B = 64
    thetas = np.hstack([
        rng.uniform(-12, 12, (B, 4)), rng.uniform(-12, 12, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    sol = mpc.engine.solve_batch(thetas)
    U = np.asarray(sol.U)
    st = np.asarray(sol.status)
    # the +/-12 sampling box contains a few genuinely infeasible instances
    # (the oracle cannot solve them either); the engine must never report
    # those as optimal -- that was a real bug: once every violated row
    # goes active, the ridge converges to a pseudo-solution that the
    # inactive-rows-only candidate test calls "converged"
    assert np.all((st == 1) | (st == -3))
    for i in range(B):
        Ur, *_, s = solve_ldp_numpy(mpc.engine.ldp, thetas[i])
        if s == 1:
            assert st[i] == 1
            assert np.max(np.abs(U[i] - Ur)) < 1e-8


def test_large_m_active_state_constraints():
    """A state pushed against the added constraint must activate it."""
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.array([[1.0, 0, 0, 0]]), lb=[-6.0], ub=[6.0],
                       ks=range(2, 31))
    mpc.setup()
    theta = mpc.form_parameter([5.9, 3.0, 0.0, 0.0], uprev=[0.0])
    U, fval, flag, info = mpc.solve(theta)
    assert flag == 1
    assert info["active"].sum() > 0


def test_crazyflie_closed_loop():
    """12-state quadrotor with hover linearization, prestabilizing feedback
    and LQR terminal cost stabilizes from a tilted initial attitude
    (reference example src/mpc_examples.jl:451-531)."""
    ex = lmpc.mpc_example("crazyflie", 8, 8)
    mpc = ex.mpc
    sc = ex.scenarios[0]

    sim = lmpc.simulate_kw(mpc, x0=sc.x0, T=1.0)
    # attitude error decays toward hover
    assert np.max(np.abs(sim.xs[3:6, -1])) < 0.02
    assert np.max(np.abs(sim.xs[3:6, -1])) < np.max(np.abs(sim.xs[3:6, 0]))
    # thrust commands respect bounds
    assert sim.us.min() > -1e-9 and sim.us.max() < 1 + 1e-9


def _largem_problem(extra_ks=range(2, 12)):
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=extra_ks)
    return mpc


def test_compact_iu_matches_full_iu():
    """The compact working-set GI loop (ops/compact_iu.py, fixed-capacity
    slot inverse) must be iteration-for-iteration equivalent to the full
    (m, m) inverse-update loop."""
    import jax
    import jax.numpy as jnp

    from linearmpc_tpu.ops.compact_iu import _active_set_loop_ciu
    from linearmpc_tpu.ops.dual_active_set import _active_set_loop_iu

    mpc = _largem_problem()
    mpc.setup()
    e = mpc.engine
    arr = e.arrays
    m = e.ldp.m
    rng = np.random.default_rng(4)
    B = 24
    thetas = np.hstack([
        rng.uniform(-12, 12, (B, 4)), rng.uniform(-12, 12, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    du_t = np.asarray(arr.du) + thetas @ np.asarray(arr.Dth).T
    dl_t = np.asarray(arr.dl) + thetas @ np.asarray(arr.Dth).T

    kw = dict(max_iter=2 * m + 24, primal_tol=1e-6, sign_tol=1e-11)
    full = jax.jit(jax.vmap(lambda du, dl: _active_set_loop_iu(
        arr, du, dl, arr.is_eq, arr.is_immutable,
        jnp.zeros(m), arr.is_eq, jnp.ones(m, bool), **kw)))
    comp = jax.jit(jax.vmap(lambda du, dl: _active_set_loop_ciu(
        arr, du, dl, arr.is_eq, arr.is_immutable,
        jnp.zeros(m), arr.is_eq, jnp.ones(m, bool), s_max=24, **kw)))
    st_f = full(du_t, dl_t)
    st_c, ovf = comp(du_t, dl_t)
    assert not np.any(np.asarray(ovf))
    assert np.array_equal(np.asarray(st_f.done), np.asarray(st_c.done))
    assert np.array_equal(np.asarray(st_f.active), np.asarray(st_c.active))
    assert np.array_equal(np.asarray(st_f.iters), np.asarray(st_c.iters))
    assert np.max(np.abs(np.asarray(st_f.lam) - np.asarray(st_c.lam))) < 1e-8


def test_compact_iu_overflow_flag():
    """A capacity smaller than the optimal working set must raise the
    overflow flag instead of returning a wrong answer."""
    import jax
    import jax.numpy as jnp

    from linearmpc_tpu.ops.compact_iu import _active_set_loop_ciu

    mpc = _largem_problem()
    mpc.setup()
    e = mpc.engine
    arr = e.arrays
    m = e.ldp.m
    theta = mpc.form_parameter([12.0, 10.0, 0.5, 0.5], uprev=[0.0])
    du_t = jnp.asarray(np.asarray(arr.du) + np.asarray(arr.Dth) @ theta)
    dl_t = jnp.asarray(np.asarray(arr.dl) + np.asarray(arr.Dth) @ theta)
    st, ovf = jax.jit(lambda du, dl: _active_set_loop_ciu(
        arr, du, dl, arr.is_eq, arr.is_immutable,
        jnp.zeros(m), arr.is_eq, jnp.ones(m, bool),
        s_max=2, max_iter=2 * m + 24, primal_tol=1e-6, sign_tol=1e-11))(du_t, dl_t)
    assert bool(ovf)


def test_compact_engine_path_large_m():
    """Engine-level compact path (f32 bulk + f64 finishing) at m > 64,
    differential vs the NumPy oracle."""
    import jax.numpy as jnp

    mpc = _largem_problem(range(2, 26))  # m = 24 + 96 = 120
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    assert e.ldp.m > 64
    assert e.bulk_route == "compact"

    rng = np.random.default_rng(6)
    B = 64
    thetas = np.hstack([
        rng.uniform(-10, 10, (B, 4)), rng.uniform(-10, 10, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    sol = e.solve_batch(thetas)
    U = np.asarray(sol.U)
    status = np.asarray(sol.status)
    checked = 0
    for i in range(B):
        Ur, *_r, s = solve_ldp_numpy(e.ldp, thetas[i])
        if s == 1:
            assert status[i] == 1, i
            assert np.max(np.abs(U[i] - Ur)) < 1e-7, i
            checked += 1
    assert checked >= B // 3


def test_inverse_update_bulk_matches_reference():
    """f32 bulk phase with O(m^2) recursive Woodbury inverse updates
    (DAQP's recursive-factorization analog) + f64 continuation must match
    the NumPy f64 reference like the Cholesky path does."""
    import jax.numpy as jnp

    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, 12))
    mpc.setup(dtype=jnp.float32)  # polish=True -> inverse-update bulk
    assert mpc.engine._solve_kw["bulk_inverse_updates"]

    rng = np.random.default_rng(2)
    B = 48
    thetas = np.hstack([
        rng.uniform(-12, 12, (B, 4)), rng.uniform(-12, 12, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    sol = mpc.engine.solve_batch(thetas)
    U = np.asarray(sol.U)
    status = np.asarray(sol.status)
    checked = 0
    for i in range(B):
        Ur, *_r, s = solve_ldp_numpy(mpc.engine.ldp, thetas[i])
        if s == 1:
            # every lane the sequential oracle certifies must converge
            # here too and agree (the device solver also certifies lanes
            # where the oracle stalls on degenerate sets -- not comparable)
            assert status[i] == 1, i
            assert np.max(np.abs(U[i] - Ur)) < 1e-8, i
            checked += 1
    assert checked >= B // 3


def test_ciu_routing_boundary(monkeypatch):
    """No cliff across the old kernel ceilings: every continuous f32
    engine beyond the subset cache takes the compact route with the
    default n + 8 slot capacity -- also when compiling for a GPU, where
    no interpreter is reachable."""
    import jax.numpy as jnp

    from linearmpc_tpu.ops import engine as engine_mod

    monkeypatch.setattr(engine_mod, "accelerator_platform", lambda: "gpu")
    for Np, m in ((127, 512), (157, 632), (223, 896)):
        mpc, _ = lmpc.mpc_examples("invpend", Np, 8)
        mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                           ks=range(2, Np + 1))
        mpc.setup(dtype=jnp.float32)
        e = mpc.engine
        assert e.ldp.m == m
        assert e.bulk_route == "compact" and not e.interpret
        assert e.ciu_s_max == 16          # n + 8 heuristic
