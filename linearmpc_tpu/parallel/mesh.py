"""Device-mesh construction and sharded batched solving.

Multi-chip scaling for the MPC workload (SURVEY.md section 2.3): the
scenario batch is data-parallel over the ``dp`` mesh axis; the solver's
constraint-row dimension (G, Dth, bounds) is model-parallel over ``mp``,
letting large condensed problems (long horizons with many stage
constraints) spread across chips. XLA GSPMD inserts the ICI collectives
from the sharding annotations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dual_active_set import LDPArrays, solve_single


def make_mesh(dp: int | None = None, mp: int = 1, devices=None) -> Mesh:
    """Build a (dp, mp) mesh over the available devices."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if dp is None:
        dp = n // mp
    assert dp * mp == n, f"mesh {dp}x{mp} != {n} devices"
    dev_array = np.asarray(devices).reshape(dp, mp)
    return Mesh(dev_array, ("dp", "mp"))


def shard_ldp_arrays(arrays: LDPArrays, mesh: Mesh) -> LDPArrays:
    """Place solver arrays on the mesh: constraint-row-sharded over ``mp``
    where the leading axis is the m-dimension, replicated otherwise."""
    m = arrays.G.shape[0]

    def place(a):
        if a.ndim >= 1 and a.shape[0] == m and m % mesh.shape["mp"] == 0 and m > 0:
            spec = P("mp") if a.ndim == 1 else P("mp", None)
        else:
            spec = P()
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree.map(place, arrays)


def make_sharded_batch_solver(engine, mesh: Mesh, **solve_kw):
    """jit-compiled batched solve with the theta batch sharded over ``dp``
    and solver arrays row-sharded over ``mp``."""
    arrays = shard_ldp_arrays(engine.arrays, mesh)
    arrays_hi = None
    if engine.arrays_hi is not None:
        arrays_hi = shard_ldp_arrays(engine.arrays_hi, mesh)
    kw = dict(engine._solve_kw)
    kw.update(solve_kw)

    theta_sharding = NamedSharding(mesh, P("dp", None))

    @jax.jit
    def solve(thetas):
        fn = lambda th: solve_single(arrays, th, ldp_hi=arrays_hi, **kw)
        return jax.vmap(fn)(thetas)

    def sharded_solve(thetas):
        thetas = jax.device_put(jnp.asarray(thetas, engine.dtype), theta_sharding)
        return solve(thetas)

    return sharded_solve


def shard_rollout(rollout, mesh: Mesh, *, N: int):
    """dp-sharded closed loop: each device along ``dp`` runs ``rollout``
    (a ``build_rollout`` function) on its own slice of the lanes under
    ``shard_map`` -- no collectives, every lane's scan stays on one device.
    Returns ``run(x0s, rs) -> RolloutResult`` sharded over ``dp``; the
    batch must divide evenly over ``dp``."""
    spec = P("dp")

    @jax.jit
    def run(x0s, rs):
        return jax.shard_map(
            lambda x, r: rollout(x, r, None, N=N), mesh=mesh,
            in_specs=(spec, spec), out_specs=spec, check_vma=False,
        )(jnp.asarray(x0s), jnp.asarray(rs))

    return run

