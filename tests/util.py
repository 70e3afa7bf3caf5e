"""Shared test helpers."""

import pathlib
import subprocess
import sys

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_test_fn_in_subprocess(module: str, fn: str, *args, timeout=2400):
    """Run ``module.fn(*args)`` in a fresh Python process and assert rc 0.

    Compiling the fidelity hop-scan form segfaults the XLA:CPU backend
    (SIGSEGV inside backend_compile_and_load / LLVM) ONLY late in a
    long-lived full-suite process — the same compile passes in any fresh
    process.  Ruled out before reaching for isolation: it is not stack
    depth (crashes identically on a 512 MB worker-thread stack) and not
    memory (128 GB free).  A fresh subprocess is the one condition known
    to always pass, so the affected test runs there; args must repr()
    round-trip.
    """
    code = (
        # same backend forcing as conftest.py (env vars alone are too late
        # once jax is imported)
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "jax.config.update('jax_num_cpu_devices', 8); "
        f"import {module} as m; m.{fn}("
        + ", ".join(repr(a) for a in args)
        + ")"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=timeout,
    )
    assert r.returncode == 0, (
        f"{module}.{fn}{args} rc={r.returncode}\n"
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    )


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of `test` against `reference`, in dB."""
    reference = np.asarray(reference, np.float64)
    test = np.asarray(test, np.float64)
    noise = np.mean((reference - test) ** 2)
    signal = np.mean(reference**2)
    if noise == 0:
        return np.inf
    return float(10.0 * np.log10(signal / max(noise, 1e-300)))


def dominant_freq(x: np.ndarray, sample_rate: float = 1.0) -> float:
    """Frequency (cycles/sample * sample_rate) of the strongest spectral peak,
    refined by parabolic interpolation."""
    x = np.asarray(x, np.float64)
    w = np.hanning(len(x))
    spec = np.abs(np.fft.rfft(x * w))
    k = int(np.argmax(spec[1:-1])) + 1
    a, b, c = np.log(spec[k - 1] + 1e-30), np.log(spec[k] + 1e-30), np.log(spec[k + 1] + 1e-30)
    denom = a - 2 * b + c
    delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
    return (k + delta) / len(x) * sample_rate


def tone(freq: float, n: int, sample_rate: float = 1.0, phase: float = 0.3):
    t = np.arange(n, dtype=np.float64)
    return np.sin(2 * np.pi * freq / sample_rate * t + phase).astype(np.float32)
