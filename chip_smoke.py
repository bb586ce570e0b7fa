"""On-card smoke test of the batched MPC solver.

Drives the main path through the entry points a user calls
(``mpc_examples`` -> ``MPC.setup`` -> ``engine.solve_batch`` /
``engine.solve`` / ``build_rollout``) at the repository's workload sizes,
and checks every phase against the plain float64 NumPy reference
(``ops/reference_solver.solve_ldp_numpy``):

  1. headline: invpend Np=50, Nc=5 (m=5), golden control, cold batch of
     32768, fused kernel vs the plain XLA path, 4096 x 500 rollout;
  2. compact: m=256 and m=48 state-boxed invpend, batches of 8192;
  3. hybrid: satellite (m=60, 40 binaries), batch of 512, against the
     float64 per-lane branch-and-bound.

``--four`` runs only the four-card phases instead: the dp-sharded headline
rollout against the single-card one, and mp-Schur at m=1024 against the
single-card solve.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs of one host

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a GPU the script exits nonzero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_U = 1.7612519326   # reference README: compute_control([5, 5, 0, 0])
TOL_GOLDEN = 1e-6         # the reference's own test tolerance
TOL_U = 1e-8              # controls vs the float64 reference
TOL_KKT = 1e-8            # float64 KKT residual of optimal lanes
TOL_MP = 1e-7             # mp-Schur vs the single-card solve
TOL_OBJ = 1e-6            # hybrid objective, relative
PRECISION = ("f32 bulk (matmul precision HIGHEST), f64 finishing "
             "and f64 KKT guard")


def log(*a):
    print(*a, flush=True)


class Checks:
    """Collects pass/fail lines; a phase fails if any check failed."""

    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail=""):
        ok = bool(ok)
        log(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
        if not ok:
            self.failed.append(name)
        return ok


def _block(x):
    import jax

    jax.tree_util.tree_leaves(x)[0].block_until_ready()
    return x


def timed(fn, *args, reps=3):
    """(result, first-call seconds incl. compile, median steady seconds)."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, t_first, float(np.median(ts)) if ts else float("nan")


def pendulum_thetas(rng, B, box_x=20.0, box_r=20.0):
    """theta = [x; r; uprev] drawn as bench.py draws the headline batch."""
    return np.hstack([
        rng.uniform(-box_x, box_x, (B, 4)),
        rng.uniform(-box_r, box_r, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ])


def kkt_residual(ldp, thetas, lam, act, side):
    """float64 KKT residual per lane, in NumPy from the returned working
    set: inactive-row primal violation, active-row multiplier sign, and
    the working-set system residual."""
    thetas = np.asarray(thetas, np.float64)
    lam = np.asarray(lam, np.float64)
    act = np.asarray(act, bool)
    side = np.asarray(side, bool)
    du = ldp.du + thetas @ ldp.Dth.T
    dl = ldp.dl + thetas @ ldp.Dth.T
    G_solve = ldp.G + np.diag(np.asarray(ldp.rho_soft, np.float64))
    c = lam @ ldp.G.T
    inact = ~act & ~np.asarray(ldp.is_immutable)
    primal = np.where(inact, np.maximum(-(du + c), dl + c), -np.inf).max(axis=1)
    sign = np.where(act & ~np.asarray(ldp.is_eq), np.where(side, -lam, lam),
                    -np.inf).max(axis=1)
    d_side = np.where(side, du, dl)
    sys_res = np.where(act, (lam * act) @ G_solve.T + d_side, 0.0)
    return np.maximum(np.maximum(primal, sign), np.abs(sys_res).max(axis=1))


def oracle_error(ldp, thetas, sol, n):
    """max |U - U_ref| over the first n lanes where the reference
    converges; returns (error, lanes compared, lanes the device failed)."""
    from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy

    U = np.asarray(sol.U, np.float64)
    st = np.asarray(sol.status)
    err, n_cmp, n_bad = 0.0, 0, 0
    for i in range(min(n, len(st))):
        U_ref, *_r, s_ref = solve_ldp_numpy(ldp, np.asarray(thetas[i], np.float64))
        if s_ref != 1:
            continue
        n_cmp += 1
        if st[i] != 1:
            n_bad += 1
            continue
        err = max(err, float(np.max(np.abs(U[i] - U_ref))))
    return err, n_cmp, n_bad


# -- phase 1 -----------------------------------------------------------------

def phase_headline(B=32768, n_ref=256, roll_lanes=4096, roll_steps=500,
                   n_first=16, reps=3, interpret=False, seed=0):
    import jax.numpy as jnp

    import linearmpc_tpu as lmpc
    from linearmpc_tpu.rollout import build_rollout

    ck = Checks()
    rng = np.random.default_rng(seed)
    log(f"phase headline: invpend Np=50 Nc=5; {PRECISION}")
    mpc, _ = lmpc.mpc_examples("invpend")
    t0 = time.perf_counter()
    mpc.setup(dtype=jnp.float32, interpret=interpret)
    e = mpc.engine
    log(f"  setup {time.perf_counter() - t0:.2f} s; m={e.ldp.m} n={e.ldp.n} "
        f"n_theta={e.ldp.n_theta}; bulk route: {e.bulk_route}")

    u = float(np.ravel(mpc.compute_control([5.0, 5.0, 0.0, 0.0]))[0])
    ck.check("golden compute_control([5,5,0,0])",
             abs(u - GOLDEN_U) <= TOL_GOLDEN,
             f"{u:.10f} vs {GOLDEN_U} (tol {TOL_GOLDEN:g})")

    thetas = jnp.asarray(pendulum_thetas(rng, B), jnp.float64)
    sol, t_c, t_s = timed(e.solve_batch, thetas, reps=reps)
    st = np.asarray(sol.status)
    log(f"  solve_batch B={B} ({e.bulk_route}): compile+first {t_c:.2f} s, "
        f"steady {t_s * 1e3:.3f} ms/batch = {B / t_s:,.0f} solves/s")
    ck.check(f"status==1 on all {B} lanes", np.all(st == 1),
             f"optimal {np.mean(st == 1):.6f}, mean iters "
             f"{np.mean(np.asarray(sol.iters)):.2f}")
    err, n_cmp, n_bad = oracle_error(e.ldp, np.asarray(thetas), sol, n_ref)
    ck.check(f"max |U - U_ref| over {n_cmp} reference lanes",
             n_cmp > 0 and n_bad == 0 and err <= TOL_U,
             f"{err:.3e} (tol {TOL_U:g}; {n_bad} device failures)")

    # the plain XLA version: vmapped solve_single, same f64 finishing
    plain, tp_c, tp_s = timed(
        lambda th: e._batched(e.arrays, e.arrays_hi, th), thetas, reps=reps)
    st_p = np.asarray(plain.status)
    both = (st == 1) & (st_p == 1)
    d_plain = float(np.max(np.abs(np.asarray(sol.U) - np.asarray(plain.U))[both])) \
        if both.any() else float("inf")
    log(f"  plain XLA (vmapped solve_single) B={B}: compile+first {tp_c:.2f} s, "
        f"steady {tp_s * 1e3:.3f} ms/batch = {B / tp_s:,.0f} solves/s; "
        f"optimal {np.mean(st_p == 1):.6f}")
    log(f"  end to end: {e.bulk_route} {t_s * 1e3:.3f} ms vs plain XLA "
        f"{tp_s * 1e3:.3f} ms per batch of {B} (ratio {tp_s / t_s:.2f})")
    ck.check("fused and plain XLA controls agree", d_plain <= TOL_U,
             f"{d_plain:.3e} over {int(both.sum())} lanes (tol {TOL_U:g})")

    roll = build_rollout(mpc)
    x0s = rng.uniform(-0.5, 0.5, (roll_lanes, 4))
    rs = np.zeros((roll_lanes, 2))
    res, tr_c, tr_s = timed(lambda x, r: roll(x, r, None, N=roll_steps), x0s, rs,
                            reps=1)
    st_r = np.asarray(res.status)
    log(f"  rollout {roll_lanes} x {roll_steps}: compile+first {tr_c:.2f} s, "
        f"steady {tr_s:.3f} s = {roll_lanes * roll_steps / tr_s:,.0f} "
        f"control-steps/s; mean iters {np.mean(np.asarray(res.iters)):.2f}")
    ck.check("rollout status==1 on every lane and step", np.all(st_r == 1),
             f"optimal {np.mean(st_r == 1):.6f}")
    us0 = np.asarray(res.us)[:, 0, :]
    d_first = 0.0
    for i in range(min(n_first, roll_lanes)):
        theta = mpc.form_parameter(x0s[i], r=np.zeros(2), uprev=np.zeros(1))
        U, _f, s_i, _info = e.solve(theta)
        u_ref = U[: mpc.model.nu] - mpc.K @ x0s[i]
        d_first = max(d_first, float(np.max(np.abs(us0[i] - u_ref))) if s_i == 1
                      else float("inf"))
    ck.check(f"rollout first-step controls vs engine.solve on {n_first} lanes",
             d_first <= TOL_U, f"{d_first:.3e} (tol {TOL_U:g})")
    return ck


# -- phase 2 -----------------------------------------------------------------

def boxed_pendulum(Np, Nc, k_hi, dtype):
    import linearmpc_tpu as lmpc

    mpc, _ = lmpc.mpc_examples("invpend", Np, Nc)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    mpc.setup(dtype=dtype)
    return mpc


def phase_compact(Np, Nc, k_hi, B, box, n_ref=64, reps=3, seed=1):
    import jax.numpy as jnp

    ck = Checks()
    rng = np.random.default_rng(seed)
    mpc = boxed_pendulum(Np, Nc, k_hi, jnp.float32)
    e = mpc.engine
    log(f"phase compact: invpend Np={Np} Nc={Nc} box ks 2..{k_hi - 1} "
        f"(m={e.ldp.m}); bulk route: {e.bulk_route}; {PRECISION}")
    thetas = jnp.asarray(pendulum_thetas(rng, B, box, box), jnp.float64)
    sol, t_c, t_s = timed(e.solve_batch, thetas, reps=reps)
    st = np.asarray(sol.status)
    log(f"  solve_batch B={B}: compile+first {t_c:.2f} s, steady "
        f"{t_s * 1e3:.3f} ms/batch = {B / t_s:,.0f} solves/s; resolved "
        f"{np.mean(st != -1):.6f} (optimal {np.mean(st == 1):.6f}, "
        f"infeasible {np.mean(st == -3):.6f})")
    opt = st == 1
    kkt = kkt_residual(e.ldp, np.asarray(thetas)[opt], np.asarray(sol.lam)[opt],
                       np.asarray(sol.active)[opt], np.asarray(sol.side)[opt])
    kmax = float(kkt.max()) if kkt.size else 0.0
    ck.check(f"f64 KKT residual on {int(opt.sum())} optimal lanes",
             opt.any() and kmax <= TOL_KKT, f"max {kmax:.3e} (tol {TOL_KKT:g})")
    err, n_cmp, n_bad = oracle_error(e.ldp, np.asarray(thetas), sol, n_ref)
    ck.check(f"max |U - U_ref| over {n_cmp} reference lanes",
             n_cmp > 0 and n_bad == 0 and err <= TOL_U,
             f"{err:.3e} (tol {TOL_U:g}; {n_bad} device failures)")
    return ck


# -- phase 3 -----------------------------------------------------------------

def phase_hybrid(B=512, n_cmp=16, reps=2, seed=2):
    import jax.numpy as jnp

    import linearmpc_tpu as lmpc

    ck = Checks()
    rng = np.random.default_rng(seed)
    mpc, _ = lmpc.mpc_examples("satellite")
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    log(f"phase hybrid: satellite (m={e.ldp.m}, "
        f"{int(np.sum(e.ldp.is_binary))} binaries); bulk route: {e.bulk_route}; "
        f"f32 node relaxations (matmul precision HIGHEST), f64 incumbent polish")
    thetas = rng.uniform(-1.0, 1.0, (B, e.ldp.n_theta))
    sol, t_c, t_s = timed(e.solve_batch, thetas, reps=reps)
    st = np.asarray(sol.status)
    log(f"  solve_batch B={B}: compile+first {t_c:.2f} s, steady "
        f"{t_s * 1e3:.3f} ms/batch = {B / t_s:,.1f} B&B solves/s; optimal "
        f"{np.mean(st == 1):.6f}, budget-limited {np.mean(st == 2):.6f}")

    mpc64, _ = lmpc.mpc_examples("satellite")
    mpc64.setup(dtype=jnp.float64)
    e64 = mpc64.engine
    ref, tr_c, _ = timed(lambda th: e64._bnb_batched(e64.arrays, e64.arrays_hi, th),
                         thetas[:n_cmp], reps=0)
    log(f"  f64 per-lane B&B on {n_cmp} lanes: {tr_c:.2f} s incl. compile")
    st_r = np.asarray(ref.status)
    both = (st[:n_cmp] == 1) & (st_r == 1)
    f, f_ref = np.asarray(sol.fval)[:n_cmp], np.asarray(ref.fval)
    rel = np.abs(f - f_ref) / np.maximum(1.0, np.abs(f_ref))
    rmax = float(rel[both].max()) if both.any() else float("inf")
    ck.check(f"objective vs f64 per-lane B&B on {int(both.sum())}/{n_cmp} lanes",
             both.sum() >= n_cmp // 2 and rmax <= TOL_OBJ
             and np.array_equal(st_r == 1, st[:n_cmp] == 1),
             f"max rel diff {rmax:.3e} (tol {TOL_OBJ:g})")
    return ck


# -- four-card phases ----------------------------------------------------------

def phase_dp_rollout(devices, lanes=4096, steps=500, interpret=False, seed=3):
    import jax
    import jax.numpy as jnp

    import linearmpc_tpu as lmpc
    from linearmpc_tpu.parallel import make_mesh, shard_rollout
    from linearmpc_tpu.rollout import build_rollout

    ck = Checks()
    rng = np.random.default_rng(seed)
    mesh = make_mesh(dp=len(devices), mp=1, devices=devices)
    log(f"phase dp rollout: invpend Np=50 Nc=5, mesh dp={len(devices)} mp=1 "
        f"over {[str(d) for d in mesh.devices.ravel()]}; {PRECISION}")
    placed = {d for d in mesh.devices.ravel()}
    ck.check("mesh spans distinct devices", len(placed) == len(devices),
             f"{len(placed)} of {len(devices)}")
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup(dtype=jnp.float32, interpret=interpret)
    roll = build_rollout(mpc)
    x0s = rng.uniform(-0.5, 0.5, (lanes, 4))
    rs = np.zeros((lanes, 2))
    run = shard_rollout(roll, mesh, N=steps)
    res, t_c, t_s = timed(run, x0s, rs, reps=1)
    shard_devs = {s.device for s in res.us.addressable_shards}
    ck.check("result shards on every mesh device", shard_devs == placed,
             f"{len(shard_devs)} devices hold shards")
    log(f"  dp rollout {lanes} x {steps}: compile+first {t_c:.2f} s, steady "
        f"{t_s:.3f} s = {lanes * steps / t_s:,.0f} control-steps/s")
    with jax.default_device(devices[0]):
        single, t1_c, t1_s = timed(lambda x, r: roll(x, r, None, N=steps),
                                   x0s, rs, reps=1)
    log(f"  single-card rollout: compile+first {t1_c:.2f} s, steady {t1_s:.3f} s")
    st = np.asarray(res.status)
    ck.check("dp rollout status==1 everywhere", np.all(st == 1),
             f"optimal {np.mean(st == 1):.6f}")
    d = float(np.max(np.abs(np.asarray(res.us) - np.asarray(single.us))))
    same_status = np.array_equal(st, np.asarray(single.status))
    ck.check("dp rollout matches the single card lane for lane",
             d <= TOL_U and same_status, f"max |du| {d:.3e} (tol {TOL_U:g})")
    return ck


def phase_mp_schur(devices, Np=255, k_hi=256, B=256, box=5.0, seed=4):
    import jax.numpy as jnp

    from linearmpc_tpu.parallel import make_mesh

    ck = Checks()
    rng = np.random.default_rng(seed)
    thetas = pendulum_thetas(rng, B, box, box)
    single = boxed_pendulum(Np, 8, k_hi, jnp.float32).engine
    m = single.ldp.m
    log(f"phase mp-Schur: invpend Np={Np} Nc=8 box ks 2..{k_hi - 1} (m={m}), "
        f"mesh dp=1 mp={len(devices)}; mp-Schur f64 CG vs single-card "
        f"{single.bulk_route} route ({PRECISION})")
    ref, tr_c, tr_s = timed(single.solve_batch, thetas, reps=1)
    log(f"  single-card B={B}: compile+first {tr_c:.2f} s, steady {tr_s:.3f} s")
    e = boxed_pendulum(Np, 8, k_hi, jnp.float64).engine
    e.attach_mesh(make_mesh(dp=1, mp=len(devices), devices=devices), force=True)
    sol, t_c, t_s = timed(e.solve_batch, thetas, reps=1)
    st, st_r = np.asarray(sol.status), np.asarray(ref.status)
    log(f"  mp-Schur B={B}: compile+first {t_c:.2f} s, steady {t_s:.3f} s = "
        f"{B / t_s:,.1f} solves/s; converged {np.mean(st == 1):.6f}")
    ok = (st == 1) & (st_r == 1)
    d = float(np.max(np.abs(np.asarray(sol.U) - np.asarray(ref.U))[ok])) \
        if ok.any() else float("inf")
    ck.check(f"mp-Schur vs single card on {int(ok.sum())} converged lanes",
             ok.mean() >= 0.5 and d <= TOL_MP, f"max |dU| {d:.3e} (tol {TOL_MP:g})")
    return ck


# -- driver ------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases (dp rollout, mp-Schur)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev} "
              f"(platform {dev.platform!r})", file=sys.stderr)
        return 1
    from linearmpc_tpu.device import card_line, enable_compile_cache

    devices = jax.devices()
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; devices: {len(devices)} x {dev.device_kind}")
    log(f"compile cache: {enable_compile_cache(ROOT)}")
    log(f"jax_default_matmul_precision: {jax.config.jax_default_matmul_precision}")

    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        devices = devices[:4]
        phases = [("dp_rollout", lambda: phase_dp_rollout(devices)),
                  ("mp_schur", lambda: phase_mp_schur(devices))]
    else:
        phases = [
            ("headline", phase_headline),
            ("compact_m256", lambda: phase_compact(63, 8, 64, 8192, 8.0)),
            ("compact_m48", lambda: phase_compact(50, 8, 12, 8192, 12.0)),
            ("hybrid", phase_hybrid),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            ck = fn()
            if ck.failed:
                failed.append(name)
        except Exception as ex:  # a phase that raises fails the run
            log(f"phase {name} raised {type(ex).__name__}: {ex}")
            failed.append(name)
        log(f"[phase {name}: {time.perf_counter() - t0:.1f} s, "
            f"{'FAILED' if name in failed else 'passed'}]")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
