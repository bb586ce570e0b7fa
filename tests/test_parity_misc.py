"""Remaining reference-parity behaviors: combined previews + explicit,
observer x preview interactions, prestab + preview closed loop, codegen
guard rails, helper coverage (reference test/runtests.jl:454-625,
1500-1618)."""

import numpy as np
import pytest

import linearmpc_tpu as lmpc
from linearmpc_tpu.condense import remove_duplicate, remove_redundant
from linearmpc_tpu.explicit import build_explicit
from linearmpc_tpu.mpc import MPC, constraint_violation
from linearmpc_tpu.types import Constraint, DenseConstraints


def _combined_preview_mpc():
    A = np.array([[1.0, 1], [0, 1]])
    B = np.array([[0.0], [1]])
    Gd = np.array([[0.5], [0.0]])
    C = np.array([[1.0, 0]])
    mpc = MPC.from_discrete(A, B, Gd=Gd, C=C, Np=5, Nc=5)
    mpc.set_bounds(umin=[-2.0], umax=[2.0])
    mpc.set_objective(Q=[5.0], R=[0.1])
    mpc.settings.reference_preview = True
    mpc.settings.disturbance_preview = True
    return mpc


def test_combined_preview_explicit_matches():
    """(reference test/runtests.jl:454-491)"""
    mpc = _combined_preview_mpc()
    mpc.setup()
    assert mpc.get_parameter_dims() == (2, 5, 5, 0, 0)

    x = np.zeros(2)
    r_traj = np.array([[0.0, 0.5, 1.0, 1.0, 1.0]])
    d_traj = np.array([[0.0, 0.2, 0.4, 0.4, 0.4]])
    u_both = mpc.compute_control(x, r=r_traj, d=d_traj)

    empc = build_explicit(mpc, prange=mpc.parameter_range())
    u_explicit = empc.compute_control(x, r=r_traj, d=d_traj)
    assert np.max(np.abs(u_explicit - u_both)) < 1e-8


def test_combined_preview_simulation():
    """(reference test/runtests.jl:493-511)"""
    mpc = _combined_preview_mpc()
    mpc.setup()
    N_sim = 15
    r_traj = np.hstack([np.zeros((1, 5)), np.ones((1, N_sim - 5))])
    d_traj = np.hstack([np.zeros((1, 8)), 0.3 * np.ones((1, N_sim - 8))])
    sim = lmpc.simulate_kw(mpc, x0=[0.0, 0.0], N=N_sim, r=r_traj, d=d_traj)
    assert sim.xs.shape == (2, N_sim)
    assert sim.us.shape == (1, N_sim)


def test_codegen_rejects_preview_with_observer(tmp_path):
    """(reference test/runtests.jl:513-525)"""
    F, G = np.array([[1.0, 1], [0, 1]]), np.array([[0.0], [1]])
    mpc = MPC.from_discrete(F, G, Gd=[[1.0], [0.0]], C=[[1.0, 0]], Np=4, Nc=4)
    mpc.set_bounds(umin=[-0.5], umax=[0.5])
    mpc.set_objective(Q=[1.0], R=[0.1])
    mpc.settings.disturbance_preview = True
    mpc.set_state_observer(Q=[1.0, 1.0], R=[0.1])
    mpc.setup()
    with pytest.raises(ValueError):
        lmpc.codegen_c(mpc, str(tmp_path))


def test_disturbance_preview_parameter_names():
    """(reference test/runtests.jl:532-553)"""
    mpc = MPC.from_discrete([[1.0, 1], [0, 1]], [[0.0], [1]],
                            Gd=[[0.5], [0.0]], C=[[1.0, 0]], Np=3, Nc=3)
    mpc.set_labels(x=["x1", "x2"], u=["u1"], y=["y1"], d=["d1"])
    mpc.set_objective(Q=[1.0], R=[0.1])
    mpc.settings.disturbance_preview = True
    mpc.setup()
    names = mpc.get_parameter_names()
    assert "x1" in names and "x2" in names
    assert "y1r" in names
    for k in range(3):
        assert f"d1_{k}" in names
    assert len(names) == 2 + 1 + 3


def test_observer_preview_matrix_disturbance():
    """(reference test/runtests.jl:566-602)"""
    F, G = np.array([[1.0, 1], [0, 1]]), np.array([[0.0], [1]])
    mpc = MPC.from_discrete(F, G, Gd=[[1.0], [0.0]], C=[[1.0, 0]], Np=4, Nc=4)
    mpc.set_bounds(umin=[-0.5], umax=[0.5])
    mpc.set_objective(Q=[1.0], R=[0.1])
    mpc.set_offset_free_observer(method="state_disturbance", Q=[1e-3, 1e-3], R=[1e-4])
    mpc.settings.disturbance_preview = True
    mpc.setup()

    assert mpc.model.nd == 2
    assert mpc.state_observer.nd_measured == 1
    assert mpc.state_observer.nd_offsetfree == 1

    x = np.zeros(2)
    u_scalar = mpc.compute_control(x, d=[0.5])
    u_mat = mpc.compute_control(x, d=np.zeros((1, 4)))
    assert len(u_scalar) == 1 and len(u_mat) == 1
    assert np.linalg.norm(u_mat - u_scalar) > 1e-6


def test_reference_preview_with_prestab():
    """(reference test/runtests.jl:604-625) triple integrator with soft
    constraints, prestab and preview tracks a piecewise reference."""
    Ac = np.diag(np.ones(2), 1)
    Bc = np.array([[0.0], [0.0], [1.0]])
    mpc = MPC.from_continuous(Ac, Bc, 1.0, C=np.eye(3), Np=10, Nc=10)
    mpc.set_objective(Q=1e-9 * np.array([10000.0, 1, 1e-4]), R=[1e-9], Qf=[1e6, 1e6, 1e6])
    mpc.set_input_bounds([-1], [1])
    mpc.add_constraint(Ax=[[0.0, 1.0, 0.0]], lb=[-1], ub=[1], soft=True)
    mpc.add_constraint(Ax=[[0.0, 0.0, 1.0]], lb=[-1], ub=[1], soft=False)
    mpc.set_prestabilizing_feedback()
    mpc.settings.reference_preview = True
    mpc.setup()

    rs = np.zeros((3, 100))
    rs[0, :50] = 1.0
    rs[0, 50:] = 0.5
    sim = lmpc.simulate_kw(mpc, x0=np.zeros(3), r=rs, N=100)
    assert abs(sim.ys[0, 29] - 1.0) < 1e-5
    assert abs(sim.ys[0, -1] - 0.5) < 1e-5


def test_codegen_reference_condensation(tmp_path):
    """C codegen with condensed reference preview matches Python
    (reference test/runtests.jl:669-733)."""
    import ctypes
    import shutil
    import subprocess

    if shutil.which("gcc") is None:
        pytest.skip("gcc not available")
    A = np.array([[1.0, 1], [0, 1]])
    B = np.array([[0.0], [1]])
    mpc = MPC.from_discrete(A, B, C=np.eye(2), Np=5, Nc=3)
    mpc.set_bounds(umin=[-2.0], umax=[2.0])
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
    mpc.settings.reference_preview = True
    mpc.settings.reference_condensation = True
    mpc.setup()

    r_traj = np.array([[0.0, 0.5, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    x = np.array([1.0, 0.0])
    u_py = mpc.compute_control(x, r=r_traj)

    cpath = lmpc.codegen_c(mpc, str(tmp_path))
    so = f"{tmp_path}/t.so"
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", so, cpath, "-lm"], check=True)
    lib = ctypes.CDLL(so)
    ct = ctypes.c_double
    u = (ct * 1)()
    r_flat = np.asarray(r_traj.T.ravel(), dtype=np.float64)  # column-major traj
    lib.mpc_compute_control(u, (ct * 2)(*x), (ct * len(r_flat))(*r_flat), None)
    assert abs(u[0] - u_py[0]) < 1e-8


def test_preprocessing_helpers():
    """Hand-built DenseConstraints through redundancy/duplicate removal
    (reference test/runtests.jl:1500-1570)."""
    A = np.array([
        [1.0, 0.0],
        [-1.0, 0.0],   # sign-flips to [1,0]
        [1.0, 1.0],
        [1.0, 1.0],    # duplicate
        [0.0, 0.0],    # zero row: dropped
    ])
    m = A.shape[0]
    c = DenseConstraints(
        A=A,
        bu=np.concatenate([[1.0, 2.0], [3.0, 4.0, 2.5, 2.0, 5.0]]),
        bl=np.concatenate([[-1.0, -2.0], [-3.0, -4.0, -2.5, -2.0, -5.0]]),
        W=np.zeros((m + 2, 3)),
        issoft=np.zeros(m + 2, dtype=bool),
        isbinary=np.zeros(m + 2, dtype=bool),
        prio=np.zeros(m + 2, dtype=int),
    )
    out = remove_redundant(c)
    # rows 0/1 of A folded into simple bound 0; zero row dropped
    assert out.A.shape[0] < m
    assert out.bu[0] <= 1.0
    out2 = remove_duplicate(out)
    assert out2.A.shape[0] <= out.A.shape[0]


def test_constraint_violation_helper():
    """(reference test/runtests.jl:1572-1601)"""
    c = Constraint(
        Au=np.array([[1.0]]), Ax=np.array([[1.0, 0.0]]),
        Ar=np.zeros((1, 0)), Aw=np.zeros((1, 0)), Ad=np.zeros((1, 0)),
        Aup=np.zeros((1, 0)), Ap=np.zeros((1, 0)),
        ub=np.array([1.0]), lb=np.array([-1.0]),
        ks=np.arange(2, 5), soft=False, binary=False, prio=0,
    )
    assert constraint_violation(c, [0.5, 0.0], [0.2]) == 0.0
    assert constraint_violation(c, [1.5, 0.0], [0.2]) == pytest.approx(0.7)
    vs = constraint_violation(c, np.array([[0.5, 1.5], [0.0, 0.0]]), np.array([[0.2, 0.2]]))
    assert vs[0] == 0.0 and vs[1] == pytest.approx(0.7)


def test_setup_warning_branches():
    """(reference test/runtests.jl:1603-1618)"""
    mpc = MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]])
    with pytest.warns(UserWarning):
        mpc.update_settings(not_a_setting=True)
    mpc.model.uo[:] = [1.0]
    mpc.set_objective(Q=[1.0], R=[1.0])
    with pytest.warns(UserWarning):
        lmpc.mpc2mpqp(mpc)  # tracking + uo + R warning
    mpc2 = MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]])
    mpc2.settings.reference_tracking = True
    assert mpc2.set_terminal_cost() is False  # warns + refuses for tracking


def test_label_helpers():
    """label2id / prettify_parameter_label / make_subscript (reference
    src/utils.jl:301-325)."""
    import linearmpc_tpu as lmpc

    mpc, _ = lmpc.mpc_examples("invpend")
    idx, pretty = lmpc.label2id(mpc, "y1r")
    assert idx == 4 and pretty == "y1^r"
    idx, pretty = lmpc.label2id(mpc, "u1p")
    assert idx == 6 and pretty == "u1^-"
    assert lmpc.label2id(mpc, "bogus") == (None, "bogus")
    assert lmpc.prettify_parameter_label("y2r_5") == "y2^r_5"
    assert lmpc.make_subscript("x12") == "x_12"
    assert lmpc.make_subscript("phi") == "phi"
