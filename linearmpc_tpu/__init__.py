"""linearmpc_tpu: a batched, accelerator-native linear Model Predictive Control framework.

Built from scratch on JAX/XLA/Pallas with the capabilities of the reference
Julia package darnstrom/LinearMPC.jl (see SURVEY.md): condensation of
constrained tracking MPC into dense multi-parametric QPs, a batched
branch-free dual active-set solver, closed-loop simulation, Kalman /
offset-free observers, hybrid (binary-control) MPC via branch-and-bound,
explicit MPC, robust tightening, invariant sets, and multi-chip scaling.
"""

from .condense import (
    get_affine_parameter_base_dim,
    get_parameter_dims,
    get_parameter_names,
    mpc2mpqp,
)
from .models.model import (
    Labels,
    Model,
    linearize,
    make_model,
    model_from_continuous,
    model_from_nonlinear,
)
from .mpc import MPC, constraint_violation, format_move_block
from .observer import KalmanFilter, OffsetFreeObserver
from .robust import constraint_tightening
from .simulation import Scenario, Simulation, get_preview, simulate, simulate_kw
from .types import (
    Constraint,
    MPCSettings,
    MPCWeights,
    MPQP,
    ParameterRange,
)
from .utils.formatting import label2id, make_subscript, prettify_parameter_label
from .utils.linalg import dare, kalman_gain, matrixify, zoh
from .explicit import ExplicitMPC, build_explicit, make_singlesided
from .certify import CertificationResult, certify
from .invariant import eliminate, invariant_set, minrep
from .codegen import codegen_c, codegen_c_explicit, export_compiled, load_compiled
from .rollout import build_rollout
from .models.statespace import model_from_statespace
from .checkpoint import load_explicit, load_problem, save_explicit, save_problem
from .profiling import SolveStats, instrument

__version__ = "0.1.0"

__all__ = [
    "MPC", "Model", "Labels", "make_model", "model_from_continuous",
    "model_from_nonlinear", "linearize", "mpc2mpqp", "get_parameter_dims",
    "get_parameter_names", "get_affine_parameter_base_dim",
    "label2id", "prettify_parameter_label", "make_subscript",
    "KalmanFilter", "OffsetFreeObserver", "Scenario", "Simulation",
    "simulate", "simulate_kw", "get_preview", "Constraint", "MPCWeights",
    "MPCSettings", "MPQP", "ParameterRange", "constraint_tightening",
    "constraint_violation", "format_move_block", "dare", "kalman_gain",
    "matrixify", "zoh",
]


def mpc_example(name, Np=None, Nc=None, **kwargs):
    """Build a canonical example controller (reference src/mpc_examples.jl)."""
    from .models.examples import mpc_example as _ex

    return _ex(name, Np, Nc, **kwargs)


def mpc_examples(name, Np=None, Nc=None, **kwargs):
    """Return (mpc, parameter_range) for an example, mirroring the reference."""
    ex = mpc_example(name, Np, Nc, **kwargs)
    return ex.mpc, ex.range


def mpc_example_names():
    from .models.examples import mpc_example_names as _names

    return _names()
