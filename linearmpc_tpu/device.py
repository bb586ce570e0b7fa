"""Device plumbing shared by the on-card scripts (``chip_smoke.py``,
``bench.py``): the GPU requirement, the card's identity, and the
persistent compilation cache."""

from __future__ import annotations

import os
import subprocess

import jax


def require_gpu():
    """The first device, which must be a GPU: a measurement that silently
    fell back to the CPU would report host numbers under device names."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, but JAX's first device is {dev} "
            f"(platform {dev.platform!r})")
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card); raises when ``nvidia-smi`` cannot be run."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def enable_compile_cache(root: str) -> str:
    """Persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when it
    is set (JAX reads the variable itself), else the fixed directory
    ``<root>/.jax_cache``. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
