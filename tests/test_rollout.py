"""Batched lax.scan rollout vs the reference-parity host loop, the NumPy
reference solver, and multi-chip sharded solving on the virtual CPU mesh."""

import numpy as np
import pytest

import linearmpc_tpu as lmpc
from linearmpc_tpu.mpc import MPC
from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy
from linearmpc_tpu.rollout import build_rollout


def test_numpy_reference_matches_device_solver():
    """Differential test: independent sequential solver vs batched kernel."""
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    rng = np.random.default_rng(0)
    for _ in range(20):
        x = rng.uniform(-10, 10, 4)
        r = rng.uniform(-5, 5, 2)
        theta = mpc.form_parameter(x, r=r, uprev=[0.0])
        U_dev, fval, flag, info = mpc.solve(theta)
        U_ref, lam_ref, work, it, status = solve_ldp_numpy(mpc.engine.ldp, theta)
        assert status == 1 and flag == 1
        assert np.max(np.abs(U_dev - U_ref)) < 1e-9


def test_rollout_matches_host_loop():
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    rollout = build_rollout(mpc)
    x0 = np.array([0.0, 0.0, 0.15, 0.0])
    N = 50
    res = rollout(x0[None, :], np.zeros((1, 2)), None, N=N)

    mpc2, _ = lmpc.mpc_examples("invpend")
    def dynamics(x, u, d):
        return mpc2.model.F @ x + mpc2.model.G @ np.atleast_1d(u)
    sim = lmpc.simulate_kw(mpc2, x0=x0, N=N, r=[0.0, 0.0], dynamics=dynamics)

    us_dev = np.asarray(res.us)[0].T
    assert np.max(np.abs(us_dev - sim.us)) < 1e-8
    assert np.max(np.abs(np.asarray(res.xs)[0].T - sim.xs)) < 1e-6


def test_rollout_with_observer_matches_host_loop():
    F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
    C = np.array([[1.0, 0]])

    def build():
        mpc = MPC.from_discrete(F, G, C=C, Ts=0.1, Np=15)
        mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
        mpc.set_bounds(umin=[-1.0], umax=[1.0])
        mpc.set_state_observer(Q=[1.0, 1.0], R=[0.1])
        return mpc

    mpc = build()
    mpc.setup()
    rollout = build_rollout(mpc)
    x0 = np.array([1.0, 0.0])
    res = rollout(x0[None, :], np.array([[0.5]]), None, N=40)

    sim = lmpc.simulate_kw(build(), x0=x0, N=40, r=[0.5])
    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8


def test_rollout_batch_lanes_independent():
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    rollout = build_rollout(mpc)
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-1, 1, (8, 4))
    rs = rng.uniform(-1, 1, (8, 2))
    res = rollout(x0s, rs, None, N=20)
    # lane 3 alone must reproduce lane 3 of the batch
    res_single = rollout(x0s[3:4], rs[3:4], None, N=20)
    assert np.allclose(np.asarray(res.us)[3], np.asarray(res_single.us)[0], atol=1e-10)
    assert np.all(np.asarray(res.status) == 1)


def test_sharded_batch_solver():
    """dp x mp sharded solve on the 8-device virtual CPU mesh."""
    import jax
    from linearmpc_tpu.parallel import make_mesh, make_sharded_batch_solver

    assert len(jax.devices()) == 8
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    mesh = make_mesh(dp=4, mp=2)
    solve = make_sharded_batch_solver(mpc.engine, mesh)

    rng = np.random.default_rng(1)
    B = 64
    thetas = np.hstack([
        rng.uniform(-10, 10, (B, 4)),
        rng.uniform(-5, 5, (B, 2)),
        np.zeros((B, 1)),
    ])
    sol = solve(thetas)
    U = np.asarray(sol.U)
    assert np.all(np.asarray(sol.status) == 1)
    # parity vs unsharded engine
    sol_ref = mpc.engine.solve_batch(thetas)
    assert np.max(np.abs(U - np.asarray(sol_ref.U))) < 1e-10


@pytest.mark.parametrize("Nc, B", [(5, 200), (8, 200), (5, 128), (8, 40)])
def test_fused_kernel_interpret_matches_xla(Nc, B):
    """The fused Triton bulk kernel (interpret mode) must agree with its
    XLA twin, the subset-cache ``_active_set_loop``, lane for lane on
    working sets and iteration counts -- at m=5 (the headline problem)
    and m=8, with batches that are and are not a multiple of the lane
    block."""
    import jax
    import jax.numpy as jnp

    from linearmpc_tpu.ops import dual_active_set as das
    from linearmpc_tpu.ops.pallas_solver import make_bulk_phase

    mpc, _ = lmpc.mpc_examples("invpend", 50, Nc)  # m = Nc bound rows
    mpc.setup(dtype=jnp.float32)
    eng = mpc.engine
    ldp, arr = eng.ldp, eng.arrays
    m = ldp.m
    assert m == Nc and eng._subset_inv is not None
    rng = np.random.default_rng(0)
    thetas = jnp.asarray(np.hstack([
        rng.uniform(-20, 20, (B, 4)), rng.uniform(-20, 20, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ]), jnp.float32)
    P = jax.lax.Precision.HIGHEST
    du_t = arr.du + jnp.dot(thetas, arr.Dth.T, precision=P)
    dl_t = arr.dl + jnp.dot(thetas, arr.Dth.T, precision=P)
    cap = 2 * m + 20
    tol = dict(primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    bulk = make_bulk_phase(eng._subset_inv, ldp.G, ldp.is_eq, ldp.is_immutable,
                           max_iter=cap, interpret=True, **tol)
    act0 = jnp.broadcast_to(arr.is_eq, (B, m))
    lam, act, side, iters, done = bulk(
        du_t, dl_t, jnp.zeros((B, m)), act0, jnp.ones((B, m), bool))
    assert lam.shape == (B, m) and iters.shape == (B,)
    st = jax.vmap(lambda a, b: das._active_set_loop(
        arr, a, b, arr.is_eq, arr.is_immutable, jnp.zeros(m, jnp.float32),
        arr.is_eq, jnp.ones(m, bool), max_iter=cap, use_cholesky=True, **tol,
    ))(du_t, dl_t)
    assert np.mean(np.asarray(done)) > 0.99
    np.testing.assert_array_equal(np.asarray(done), np.asarray(st.done))
    agree = np.mean(np.all(np.asarray(act) == np.asarray(st.active), axis=1))
    assert agree > 0.98
    assert np.mean(np.asarray(iters) == np.asarray(st.iters)) > 0.98


@pytest.mark.parametrize("Nc", [5, 8])
def test_fused_rollout_matches_xla(Nc):
    """The fused rollout (bulk kernel in interpret mode + f64 finishing
    per scan step) must produce the same closed loop as the vmapped
    ``solve_single`` rollout."""
    import jax.numpy as jnp

    mpc, _ = lmpc.mpc_examples("invpend", 50, Nc)
    mpc.setup(dtype=jnp.float32, interpret=True)
    assert mpc.engine.bulk_route == "fused"
    roll_fused = build_rollout(mpc)
    mpc2, _ = lmpc.mpc_examples("invpend", 50, Nc)
    mpc2.setup(dtype=jnp.float32)
    assert mpc2.engine.bulk_route == "vmap"
    roll_xla = build_rollout(mpc2)

    rng = np.random.default_rng(5)
    B, N = 40, 6
    x0s = rng.uniform(-3, 3, (B, 4))
    rs = np.zeros((B, 2))
    rf = roll_fused(x0s, rs, None, N=N)
    rx = roll_xla(x0s, rs, None, N=N)
    assert np.all(np.asarray(rf.status) == 1)
    assert np.max(np.abs(np.asarray(rf.us) - np.asarray(rx.us))) < 1e-8
    assert np.max(np.abs(np.asarray(rf.xs) - np.asarray(rx.xs))) < 1e-8


def test_rollout_reference_preview_matches_host():
    from linearmpc_tpu.mpc import MPC as _MPC

    def build():
        A = np.array([[1.0, 1], [0, 1]])
        B = np.array([[0.0], [1]])
        mpc = _MPC.from_discrete(A, B, C=np.eye(2), Np=5, Nc=3)
        mpc.set_bounds(umin=[-2.0], umax=[2.0])
        mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
        mpc.settings.reference_preview = True
        return mpc

    N = 20
    r_traj = np.zeros((2, N))
    r_traj[0, 10:] = 1.0

    mpc = build()
    mpc.setup()
    rollout = build_rollout(mpc)
    res = rollout(np.array([[1.0, 0.0]]), r_traj.T[None, :, :], None, N=N)

    sim = lmpc.simulate_kw(build(), x0=[1.0, 0.0], N=N, r=r_traj)
    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8


def test_rollout_disturbance_preview_matches_host():
    from linearmpc_tpu.mpc import MPC as _MPC

    def build():
        A = np.array([[1.0, 1], [0, 1]])
        B = np.array([[0.0], [1]])
        Gd = np.array([[0.0], [1]])
        mpc = _MPC.from_discrete(A, B, Gd=Gd, C=[[1.0, 0]], Np=5, Nc=5)
        mpc.set_bounds(umin=[-0.5], umax=[0.5])
        mpc.set_objective(Q=[10.0], R=[0.1])
        mpc.settings.disturbance_preview = True
        return mpc

    N = 20
    d_traj = np.hstack([np.zeros((1, 8)), np.ones((1, 12))])

    mpc = build()
    mpc.setup()
    rollout = build_rollout(mpc)
    res = rollout(np.zeros((1, 2)), None, d_traj.T[None, :, :], N=N)

    sim = lmpc.simulate_kw(build(), x0=[0.0, 0.0], N=N, d=d_traj)
    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8


def test_rollout_generalized_parameters():
    from linearmpc_tpu.mpc import MPC as _MPC

    def build():
        A = np.array([[0.0, -0.37], [0.37, 0.74]])
        B = np.array([[0.37], [0.26]])
        mpc = _MPC.from_discrete(A, B, C=np.eye(2), Np=5, Nc=3)
        mpc.set_bounds(umin=[-2.0], umax=[2.0])
        mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Eu=[[1.0]])
        return mpc

    N = 15
    p_traj = -0.5 * np.ones((1, N))

    mpc = build()
    mpc.setup()
    rollout = build_rollout(mpc)
    res = rollout(np.array([[1.0, 0.0]]), np.zeros((1, 2)), None,
                  ps=p_traj.T[None, :, :], N=N)

    sim = lmpc.simulate_kw(build(), x0=[1.0, 0.0], N=N, r=np.zeros((2, N)), p=p_traj)
    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8


def test_cold_vs_warm_start_equality():
    """Warm-started solves must reproduce cold-start solutions exactly
    (reference test/runtests.jl:85-117)."""
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    rng = np.random.default_rng(21)
    B = 32
    thetas = np.hstack([
        rng.uniform(-10, 10, (B, 4)), rng.uniform(-10, 10, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])
    cold = mpc.engine.solve_batch(thetas)
    # perturb the parameters slightly and warm start from the cold solution
    thetas2 = thetas + rng.uniform(-0.05, 0.05, thetas.shape)
    import jax.numpy as jnp

    warm = (jnp.asarray(cold.lam), jnp.asarray(cold.active), jnp.asarray(cold.side))
    sol_warm = mpc.engine.solve_batch(thetas2, warm=warm)
    sol_cold = mpc.engine.solve_batch(thetas2)
    assert np.all(np.asarray(sol_warm.status) == 1)
    assert np.max(np.abs(np.asarray(sol_warm.U) - np.asarray(sol_cold.U))) < 1e-9
    # warm starts near the solution should need fewer iterations
    assert np.mean(np.asarray(sol_warm.iters)) <= np.mean(np.asarray(sol_cold.iters))


def test_rollout_offset_free_observer_matches_host_loop():
    """Offset-free observer inside the scan: the augmented estimator state
    rides the carry and its estimated disturbance feeds theta
    (reference src/observer.jl:203-225, src/simulation.jl:87)."""
    F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
    C = np.array([[1.0, 0]])
    f_plant = np.array([0.01, 0.0])

    def build():
        mpc = MPC.from_discrete(F, G, C=C, Ts=0.1, Np=20)
        mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
        mpc.set_bounds(umin=[-1.0], umax=[1.0])
        mpc.set_offset_free_observer(method="velocity", Q=[1e-3, 1e-3], R=[1e-4])
        return mpc

    N = 100
    host = build()
    sim = lmpc.simulate_kw(
        host, x0=np.zeros(2), N=N, r=[0.5],
        dynamics=lambda x, u, d: F @ x + G @ np.atleast_1d(u) + f_plant,
    )

    dev = build()
    dev.setup()
    rollout = build_rollout(dev, plant=(F, G, f_plant))
    res = rollout(np.zeros((1, 2)), np.full((1, 1), 0.5), None, N=N)

    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8
    assert np.max(np.abs(np.asarray(res.xs)[0].T - sim.xs)) < 1e-7
    assert abs(np.asarray(res.xs)[0, -1, 0] - 0.5) < 1e-3  # offset-free tracking


def test_rollout_offset_free_with_measured_disturbance_matches_host_loop():
    """Measured + estimated disturbance channels merged per step."""
    F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
    C = np.array([[1.0, 0]])
    Gd_m = np.array([[1.0], [0.0]])

    def build():
        mpc = MPC.from_discrete(F, G, C=C, Gd=Gd_m, Ts=0.1, Np=20)
        mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
        mpc.set_bounds(umin=[-1.0], umax=[1.0])
        mpc.set_offset_free_observer(method="velocity", Q=[1e-3, 1e-3], R=[1e-4])
        return mpc

    N = 80
    d_const = 0.05
    host = build()
    sim = lmpc.simulate_kw(
        host, x0=np.zeros(2), N=N, r=[0.3], d=[d_const],
        dynamics=lambda x, u, d: F @ x + G @ np.atleast_1d(u) + Gd_m @ np.atleast_1d(d),
    )

    dev = build()
    dev.setup()
    rollout = build_rollout(dev)
    res = rollout(np.zeros((1, 2)), np.full((1, 1), 0.3), np.full((1, 1), d_const), N=N)

    assert np.max(np.abs(np.asarray(res.us)[0].T - sim.us)) < 1e-8
    assert np.max(np.abs(np.asarray(res.xs)[0].T - sim.xs)) < 1e-7
