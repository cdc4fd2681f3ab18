"""Process-level settings shared by the entry points (main.py, the bench
scripts, tools/profile_kd.py and chip_smoke.py)."""

from __future__ import annotations

import os
import subprocess

# Fixed inside the checkout, so that later runs from the same checkout find
# what earlier ones compiled.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str:
    """Where compiled programs are cached: $JAX_COMPILATION_CACHE_DIR when
    set, else <checkout>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache before the first compile.
    JAX reads $JAX_COMPILATION_CACHE_DIR itself; only when it is unset is
    the directory set here. Returns the directory in use."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return compile_cache_dir()


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, one
    line per card, read in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
