"""Hybrid (binary-control) MPC via branch-and-bound, robust MPC, and
game-theoretic MPC (reference test/runtests.jl:820-880, 1337-1359)."""

import numpy as np
import pytest

import linearmpc_tpu as lmpc
from linearmpc_tpu.mpc import MPC


def test_hybrid_satellite():
    """(reference test/runtests.jl:820-834)"""
    mpc, _ = lmpc.mpc_examples("satellite", 20)
    mpc.settings.reference_preview = True
    N = 20
    rs = np.vstack([
        np.hstack([np.zeros((1, 5)), 0.5 * np.ones((1, N - 5))]),
        np.zeros((2, N)),
    ])

    def dynamics(x, u, d):
        return mpc.model.F @ x + mpc.model.G @ np.atleast_1d(u)

    sim = lmpc.simulate_kw(mpc, x0=np.zeros(3), N=N, r=rs, dynamics=dynamics)
    assert mpc.mpQP.has_binaries
    assert abs(sim.ys[0, -1] - 0.5) < 1e-3
    for bin_id in mpc.binary_controls:
        at_min = np.isclose(sim.us[bin_id, :], mpc.umin[bin_id], atol=1e-5)
        at_max = np.isclose(sim.us[bin_id, :], mpc.umax[bin_id], atol=1e-5)
        assert np.all(at_min | at_max)


def test_hybrid_invpend_contact():
    """invpend_contact condenses with binaries (the reference only condenses
    this example in its tests, test/runtests.jl:40-41; its 7th input keeps a
    padded infinite lower bound) and the B&B solve puts every finite-bounded
    binary on one of its bounds."""
    mpc, _ = lmpc.mpc_examples("invpend_contact", 6, 6, params={"nwalls": 1})
    mpc.setup()
    assert mpc.mpQP.has_binaries
    u = mpc.compute_control([0.0, 0.05, 0.0, 0.0])
    assert len(u) == 7
    for bin_id in mpc.binary_controls:
        if mpc.umin[bin_id] < -1e20 or mpc.umax[bin_id] > 1e20:
            continue  # padded infinite bound: not branchable
        assert (
            abs(u[bin_id] - mpc.umin[bin_id]) < 1e-5
            or abs(u[bin_id] - mpc.umax[bin_id]) < 1e-5
        )


def test_bnb_matches_enumeration():
    """Cross-check B&B against brute-force enumeration on a small MIQP."""
    mpc = MPC.from_discrete([[1.0, 0.1], [0, 1.0]], [[0.0], [1.0]], Np=3, Nc=3)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Rr=[0.0])
    mpc.set_bounds(umin=[0.0], umax=[1.0])
    mpc.set_binary_controls([0])
    mpc.settings.reference_tracking = False
    mpc.setup()

    x0 = np.array([0.3, -0.4])
    theta = mpc.form_parameter(x0)
    U_bnb, fval_bnb, flag, _ = mpc.solve(theta)
    assert flag == 1

    # brute force over all 2^3 binary assignments
    qp = mpc.mpQP
    best = (np.inf, None)
    H, f_t = qp.H, qp.f + qp.f_theta @ theta
    for bits in range(8):
        fixed = [(bits >> k) & 1 for k in range(3)]
        U = np.array(fixed, dtype=float)  # u in {0,1}^3
        val = 0.5 * U @ H @ U + f_t @ U
        if val < best[0]:
            best = (val, U)
    assert np.allclose(U_bnb, best[1], atol=1e-6)
    assert abs(fval_bnb - best[0]) < 1e-8


def test_robust_mpc():
    """(reference test/runtests.jl:860-880) tightening keeps the state above
    a bound the nominal controller violates."""
    F = np.array([[1.0, 1], [0, 1]])
    G = np.array([[1.0], [0.5]])
    mpc = MPC.from_discrete(F, G, Np=10)
    mpc.set_prestabilizing_feedback()
    mpc.set_bounds(umin=[-1.0], umax=[1.0])
    mpc.set_output_bounds(ymin=-0.15 * np.ones(2), ymax=np.ones(2), soft=False)
    qp_nominal = lmpc.mpc2mpqp(mpc)

    def dynamics(x, u, d):
        return mpc.model.F @ x + mpc.model.G @ np.atleast_1d(u)

    x0 = np.array([0.9, 0.5])
    sim_nominal = lmpc.simulate_kw(mpc, x0=x0, N=100, r=[0.0, 0], dynamics=dynamics)
    assert sim_nominal.xs[1, :].min() < -0.1

    mpc.set_disturbance([-1e-2, -1e-1], [1e-2, 1e-1])
    qp_tight = lmpc.mpc2mpqp(mpc)
    assert qp_tight.bu.sum() < qp_nominal.bu.sum()
    assert qp_tight.bl.sum() > qp_nominal.bl.sum()
    sim_tight = lmpc.simulate_kw(mpc, x0=x0, N=100, r=[0.0, 0], dynamics=dynamics)
    assert sim_tight.xs[1, :].min() > -0.1


def test_game_theoretic_mpc():
    """(reference test/runtests.jl:1337-1359) two-player Nash MPC yields a
    non-symmetric H solved in AVI mode; closed loop reaches the reference."""
    F = np.array([[1.0, 0.1], [0, 1]])
    G = np.array([[0.0, 0], [1, 1]])
    mpc = MPC.from_discrete(F, G, C=np.eye(2), Np=10)
    mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
    mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
    mpc.set_bounds(umin=-np.ones(2), umax=np.ones(2))
    mpc.move_block([1, 1, 8])
    mpc.setup()
    assert not np.allclose(mpc.mpQP.H, mpc.mpQP.H.T)

    sim = lmpc.simulate_kw(mpc, x0=10 * np.ones(2), r=[10, 0], N=500)
    assert abs(sim.ys[0, -1] - 10.0) < 1e-4
    assert abs(sim.ys[1, -1] - 0.0) < 1e-4


def test_evaluate_cost():
    """(reference test/runtests.jl:809-818)"""
    mpc, _ = lmpc.mpc_examples("invpend")
    rs = np.hstack([np.zeros((2, 20)), np.tile([[10.0], [0]], (1, 80))])

    def dynamics(x, u, d):
        return mpc.model.F @ x + mpc.model.G @ np.atleast_1d(u)

    sim = lmpc.simulate_kw(mpc, x0=np.zeros(4), N=100, r=rs, dynamics=dynamics)
    assert mpc.evaluate_cost(sim.xs, sim.us, sim.rs) > 0


def test_control_trajectory():
    """(reference test/runtests.jl:882-892)"""
    A = np.array([[1.0, 1], [0, 1]])
    B = np.array([[0.0], [1]])
    mpc = MPC.from_discrete(A, B, C=np.eye(2), Np=5, Nc=5)
    x = np.array([0.5, 1.0])
    u = mpc.compute_control(x)
    utraj = mpc.compute_control_trajectory(x)
    assert len(utraj) == 5
    assert np.allclose(u, utraj[:1])


def test_frontier_matches_perlane():
    """The batched node-frontier B&B (ops/bnb_frontier.py, the
    production batched path) must return the same optima as the per-lane DFS."""
    from linearmpc_tpu.ops.bnb_frontier import make_xla_relax, solve_bnb_frontier

    mpc, _ = lmpc.mpc_examples("satellite", 6, 6)
    mpc.setup()
    e = mpc.engine
    assert e.has_binaries and getattr(e, "use_frontier", False)
    rng = np.random.default_rng(11)
    B = 12
    ths = rng.uniform(-1.5, 1.5, (B, e.ldp.n_theta))

    sol_f = e.solve_batch(ths)  # frontier (XLA relax on CPU)
    # per-lane DFS reference
    sol_p = e._bnb_batched(e.arrays, e.arrays_hi, np.asarray(ths))

    st_f = np.asarray(sol_f.status)
    st_p = np.asarray(sol_p.status)
    assert np.array_equal(st_f == 1, st_p == 1)
    ok = st_f == 1
    assert np.max(np.abs(np.asarray(sol_f.fval)[ok] - np.asarray(sol_p.fval)[ok])) < 1e-8
    assert np.max(np.abs(np.asarray(sol_f.U)[ok] - np.asarray(sol_p.U)[ok])) < 1e-7


@pytest.mark.parametrize("dtype, u_tol, f_tol", [
    ("float64", 1e-6, 1e-8),
    # f32 node relaxations + f64 incumbent polish (the accelerator route)
    ("float32", 1e-5, 1e-6),
])
def test_frontier_matches_enumeration(dtype, u_tol, f_tol):
    """Frontier B&B against brute-force enumeration over all binary
    assignments (bound-constrained binaries: U entries in {umin, umax}).
    Regression for the incumbent-pinning bug: fixed binary rows satisfied
    at their clamped bound with zero multiplier must still be pinned (at
    the branched side) in the recorded active set, or the final f64
    polish re-solves the unclamped problem and drifts off the bound."""
    import jax.numpy as jnp

    mpc = MPC.from_discrete([[1.0, 0.1], [0, 1.0]], [[0.0], [1.0]], Np=4, Nc=4)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Rr=[0.0])
    mpc.set_bounds(umin=[0.0], umax=[1.0])
    mpc.set_binary_controls([0])
    mpc.settings.reference_tracking = False
    mpc.setup(dtype=getattr(jnp, dtype))
    e = mpc.engine
    assert e.bulk_route == "frontier"

    rng = np.random.default_rng(5)
    ths = rng.uniform(-1.0, 1.0, (8, e.ldp.n_theta))
    sol = e.solve_batch(ths)
    qp = mpc.mpQP
    for i in range(ths.shape[0]):
        assert int(sol.status[i]) == 1
        f_t = qp.f + qp.f_theta @ ths[i]
        best = (np.inf, None)
        for bits in range(16):
            U = np.array([(bits >> k) & 1 for k in range(4)], dtype=float)
            val = 0.5 * U @ qp.H @ U + f_t @ U
            if val < best[0]:
                best = (val, U)
        assert np.allclose(np.asarray(sol.U[i]), best[1], atol=u_tol), i
        assert abs(float(sol.fval[i]) - best[0]) < f_tol


def test_bnb_warm_start_matches_cold():
    """Warm-starting child nodes from the parent relaxation (DAQP-style
    workspace reuse) must not change solutions, only iteration counts."""
    import jax

    import linearmpc_tpu as lmpc
    from linearmpc_tpu.ops.bnb import solve_bnb_single

    mpc, _ = lmpc.mpc_examples("satellite")
    mpc.setup()
    e = mpc.engine
    assert e.has_binaries
    rng = np.random.default_rng(3)
    nth = e.ldp.n_theta
    kw = dict(stack_cap=16, node_limit=1024)

    warm_it = cold_it = 0
    for _ in range(12):
        th = rng.uniform(-1.5, 1.5, nth)
        sw = jax.jit(lambda t: solve_bnb_single(e.arrays, t, warm_nodes=True, **kw))(th)
        sc = jax.jit(lambda t: solve_bnb_single(e.arrays, t, warm_nodes=False, **kw))(th)
        assert int(sw.status) == int(sc.status)
        if int(sc.status) == 1:
            assert abs(float(sw.fval) - float(sc.fval)) < 1e-7
            assert np.max(np.abs(np.asarray(sw.U) - np.asarray(sc.U))) < 1e-6
        warm_it += int(sw.iters)
        cold_it += int(sc.iters)
    # the point of warm starts: fewer total inner iterations
    assert warm_it < cold_it, (warm_it, cold_it)


@pytest.mark.slow
def test_frontier_solves_contact_scale():
    """Batched frontier B&B on the colliding pendulum at Np=6 (m=142,
    24 binaries, degenerate relaxations): the Cholesky node solver must
    find the same optima as the per-lane DFS -- the GI node solver
    cycles/fabricates dual rays here. Np=6 rather than the full Np=10:
    the HONEST full-size tree (after the r4 example fix -- the old
    'routine m=250 solves' were a meaningless -1e30-bound encoding)
    needs ~63k node iterations per lane, ~20 min of CPU f64 per lane
    pair."""
    import numpy as np

    mpc, _ = lmpc.mpc_examples("invpend_contact", 6, 6)
    mpc.setup()
    e = mpc.engine
    assert e.bulk_route == "frontier"
    rng = np.random.default_rng(0)
    B = 4
    ths = rng.uniform(-0.3, 0.3, (B, e.ldp.n_theta))
    sol_f = e.solve_batch(ths)
    sol_d = e._bnb_batched(e.arrays, e.arrays_hi, np.asarray(ths))
    st_f = np.asarray(sol_f.status)
    st_d = np.asarray(sol_d.status)
    assert np.all(st_d == 1)
    assert np.all(st_f == 1), st_f
    assert np.max(np.abs(np.asarray(sol_f.fval) - np.asarray(sol_d.fval))) < 1e-6


def test_frontier_cold_nodes_matches_enumeration():
    """Regression (code review r3): solve_bnb_frontier with
    warm_nodes=False recorded incumbents WITHOUT pinning the fixed binary
    rows at their branched bound -- the f64 polish then solved the
    unclamped problem and returned a wrong optimum with status 1 (4 of 8
    lanes wrong on this instance)."""
    from linearmpc_tpu.ops.bnb_frontier import make_xla_relax, solve_bnb_frontier

    mpc = MPC.from_discrete([[1.0, 0.1], [0, 1.0]], [[0.0], [1.0]], Np=4, Nc=4)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Rr=[0.0])
    mpc.set_bounds(umin=[0.0], umax=[1.0])
    mpc.set_binary_controls([0])
    mpc.settings.reference_tracking = False
    mpc.setup()
    e = mpc.engine

    relax = make_xla_relax(e.arrays, max_iter=100,
                           primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    rng = np.random.default_rng(5)
    ths = rng.uniform(-1.0, 1.0, (8, e.ldp.n_theta))
    import jax

    sol = jax.jit(lambda t: solve_bnb_frontier(
        e.arrays, e.arrays_hi, t, relax, warm_nodes=False))(ths)
    qp = mpc.mpQP
    for i in range(ths.shape[0]):
        assert int(sol.status[i]) == 1
        f_t = qp.f + qp.f_theta @ ths[i]
        best = (np.inf, None)
        for bits in range(16):
            U = np.array([(bits >> k) & 1 for k in range(4)], dtype=float)
            val = 0.5 * U @ qp.H @ U + f_t @ U
            if val < best[0]:
                best = (val, U)
        assert np.allclose(np.asarray(sol.U[i]), best[1], atol=1e-6), i


def test_frontier_batch_sizes():
    """The frontier takes any batch size: a batch that is not a multiple
    of any lane block is solved as it is, with no padding lanes."""
    import jax.numpy as jnp

    mpc = MPC.from_discrete([[1.0, 0.1], [0, 1.0]], [[0.0], [1.0]], Np=4, Nc=4)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Rr=[0.0])
    mpc.set_bounds(umin=[0.0], umax=[1.0])
    mpc.set_binary_controls([0])
    mpc.settings.reference_tracking = False
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    assert e.bulk_route == "frontier"

    rng = np.random.default_rng(7)
    B = 200
    ths = rng.uniform(-1.0, 1.0, (B, e.ldp.n_theta))
    sol = e.solve_batch(ths)
    assert sol.U.shape[0] == B
    assert np.mean(np.asarray(sol.status) == 1) > 0.99


def test_frontier_f64_nodes_on_f32_engine():
    """A reduced-precision (f32 bulk) engine must route m>64 hybrid
    frontiers through f64 Cholesky node relaxations -- the f32 ridge (~100 m eps32) cannot resolve the
    contact problem's massively dual-degenerate relaxations and every
    lane returned an honest -1 before. Differential vs the f64 DFS."""
    import jax.numpy as jnp
    import numpy as np

    mpc, _ = lmpc.mpc_examples("invpend_contact", 4, 4)
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    assert e.bulk_route == "frontier"
    assert e.ldp.m > 64  # cholesky mode
    rng = np.random.default_rng(3)
    ths = rng.uniform(-0.3, 0.3, (4, e.ldp.n_theta))
    sol_f = e.solve_batch(ths)

    mpc64, _ = lmpc.mpc_examples("invpend_contact", 4, 4)
    mpc64.setup()  # f64 engine
    e64 = mpc64.engine
    sol_d = e64._bnb_batched(e64.arrays, e64.arrays_hi, np.asarray(ths))
    st_f = np.asarray(sol_f.status)
    st_d = np.asarray(sol_d.status)
    assert np.all(st_d == 1)
    assert np.all(st_f == 1), st_f
    assert np.max(np.abs(np.asarray(sol_f.fval) - np.asarray(sol_d.fval))) < 1e-6
    assert np.max(np.abs(np.asarray(sol_f.U) - np.asarray(sol_d.U))) < 1e-5


def test_bnb_status_two_budget_limited():
    """A B&B lane that holds an exact incumbent but whose search was
    stopped by the node budget must report status 2 (best found under
    budget), not overstate 1 (proven optimal). Starve the frontier's node
    limit so only the first dive completes."""
    import jax
    import numpy as np

    from linearmpc_tpu.ops.bnb_frontier import make_xla_relax, solve_bnb_frontier

    mpc, _ = lmpc.mpc_examples("invpend_contact", 4, 4)
    mpc.setup()
    e = mpc.engine
    rng = np.random.default_rng(3)
    ths = rng.uniform(-0.3, 0.3, (2, e.ldp.n_theta))
    relax = make_xla_relax(e.arrays, max_iter=2 * e.ldp.m + 24, mode="cholesky",
                           primal_tol=e.primal_tol, sign_tol=e.sign_tol)

    def run(node_limit):
        return jax.jit(lambda t: solve_bnb_frontier(
            e.arrays, e.arrays_hi, t, relax, stack_cap=50,
            node_limit=node_limit))(ths)

    full = run(e.bnb_node_limit)
    assert np.all(np.asarray(full.status) == 1)
    starved = run(40)
    st = np.asarray(starved.status)
    # the dive still finds the true optimum here, but the claim is weaker
    assert np.all(st == 2), st
    assert np.allclose(np.asarray(starved.fval), np.asarray(full.fval),
                       rtol=1e-9, atol=1e-9)
