"""Route choice, device plumbing and the on-card smoke script, on the CPU.

The GPU route is exercised here without a GPU: the engine's platform query
is monkeypatched to "gpu" (no kernel runs), and the smoke script's phases
run at tiny sizes with the fused kernel in interpret mode."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops import engine as engine_mod

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _satellite():
    return lmpc.mpc_examples("satellite")[0]


def _boxed(Np, k_hi):
    return chip_smoke.boxed_pendulum(Np, 8, k_hi, jnp.float32)


@pytest.mark.parametrize("build, dtype, route", [
    (lambda: lmpc.mpc_examples("invpend")[0], jnp.float32, "fused"),
    (lambda: lmpc.mpc_examples("invpend", 50, 8)[0], jnp.float32, "fused"),
    (lambda: lmpc.mpc_examples("invpend")[0], jnp.float64, "vmap"),
    (_satellite, jnp.float32, "frontier"),
], ids=["m5", "m8", "m5-f64", "hybrid"])
def test_engine_routes_on_gpu(monkeypatch, build, dtype, route):
    """With the platform query answering "gpu", f32 small-m engines take
    the fused Triton route -- compiled, never interpreted -- and nothing
    else changes route."""
    monkeypatch.setattr(engine_mod, "accelerator_platform", lambda: "gpu")
    mpc = build()
    mpc.setup(dtype=dtype)
    e = mpc.engine
    assert e.bulk_route == route
    assert e.interpret is False
    assert hasattr(e, "fused_rollout_solve") == (route == "fused")


def test_engine_routes_on_cpu():
    """On the CPU the fused kernel is reachable only through the explicit
    ``interpret`` argument."""
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup(dtype=jnp.float32)
    assert mpc.engine.bulk_route == "vmap"
    mpc.setup(dtype=jnp.float32, interpret=True)
    assert mpc.engine.bulk_route == "fused" and mpc.engine.interpret
    assert _boxed(30, 12).engine.bulk_route == "compact"


def test_no_tpu_kernels_in_package():
    """No module of the package imports the Mosaic-TPU Pallas backend."""
    pkg = ROOT / "linearmpc_tpu"
    offenders = [str(p) for p in pkg.rglob("*.py")
                 if "pallas.tpu" in p.read_text() or "pltpu" in p.read_text()]
    assert not offenders, offenders


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """``JAX_COMPILATION_CACHE_DIR`` wins when set (and the config is left
    alone); otherwise the cache sits at the fixed ``<root>/.jax_cache``."""
    from linearmpc_tpu.device import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
            assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "cc")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache(str(tmp_path))
            assert path == os.path.join(str(tmp_path), ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_refuses_unknown_device():
    from linearmpc_tpu.profiling import device_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("TFRT_CPU")


def test_peak_table_h100():
    from linearmpc_tpu.profiling import device_peaks

    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops"] == 989e12 and pk["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in pk["source"]


@pytest.mark.gpu
def test_fused_kernel_compiled_matches_xla(gpu_device):
    """The compiled Triton kernel agrees with the XLA twin on a card."""
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    assert e.bulk_route == "fused"
    th = chip_smoke.pendulum_thetas(np.random.default_rng(0), 1000)
    a = e.solve_batch(th)
    b = e._batched(e.arrays, e.arrays_hi, jnp.asarray(th))
    assert np.max(np.abs(np.asarray(a.U) - np.asarray(b.U))) < 1e-8


# -- chip_smoke.py: phases at tiny sizes, and the no-GPU exit ---------------

def test_chip_smoke_headline_tiny():
    ck = chip_smoke.phase_headline(B=40, n_ref=6, roll_lanes=8, roll_steps=4,
                                   n_first=3, reps=1, interpret=True)
    assert ck.failed == []


def test_chip_smoke_compact_tiny():
    assert chip_smoke.phase_compact(30, 8, 12, 48, 12.0, n_ref=6, reps=1).failed == []


def test_chip_smoke_hybrid_tiny():
    assert chip_smoke.phase_hybrid(B=6, n_cmp=3, reps=1).failed == []


def test_chip_smoke_four_card_phases_tiny():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    ck = chip_smoke.phase_dp_rollout(devs, lanes=8, steps=3, interpret=True)
    assert ck.failed == []
    assert chip_smoke.phase_mp_schur(devs, Np=30, k_hi=12, B=6).failed == []


def test_chip_smoke_checks_fail_closed():
    ck = chip_smoke.Checks()
    assert ck.check("ok", True) and not ck.check("bad", np.nan < 1.0)
    assert ck.failed == ["bad"]
    # a NaN residual never passes a tolerance test
    kkt = chip_smoke.kkt_residual(_boxed(30, 12).engine.ldp, np.zeros((1, 7)),
                                  np.full((1, 48), np.nan), np.ones((1, 48), bool),
                                  np.ones((1, 48), bool))
    assert not kkt.max() <= chip_smoke.TOL_KKT


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_main_fails_without_gpu(tmp_path, alone):
    """Without a GPU (and alone, without the package) the script exits
    nonzero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
