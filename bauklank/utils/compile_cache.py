"""Persistent XLA compile cache and the accelerator check of the entry points.

``enable_compile_cache`` is called once by every entry point that compiles
(``bench.py``, ``chip_smoke.py``, ``benchmarks/*.py``, the CLI).  When
``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and nothing is set
here; otherwise the cache lives at a fixed path inside the checkout
(``.cache/jax``, git-ignored), so repeated runs from one checkout hit it.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_DIR)


def require_gpu():
    """The first JAX device, which must be a GPU: measurement entry points
    fail on a machine without one instead of running on the CPU."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # no backend could be initialised
        raise SystemExit(f"no GPU: {e}") from None
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found only {devices[0].platform} devices")
    return devices[0]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0]


def power_limit_w(line: str) -> float | None:
    """Watts from a ``card_line`` (``"NVIDIA H100 80GB HBM3, 700.00 W"``)."""
    try:
        return float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None
