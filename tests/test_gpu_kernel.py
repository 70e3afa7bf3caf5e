"""On-card checks of the compiled band-chain kernel (marker ``gpu``).

The CPU suite runs the kernel only through the Pallas interpreter; these
tests compile it for the card and skip on a machine without a GPU.  Run on
the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernel.py``.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


def test_compiled_kernel_matches_interpret_and_scan(gpu_device):
    """The compiled kernel against the interpreter and the lax.scan on the
    same inputs.  Tolerance: the compiled kernel rounds each mul/div/sqrt
    separately (inline PTX), the interpreter and the scan run XLA's GPU
    code, which may contract mul+add into FMA; the chain carries a
    last-bit difference forward, so 1e-4 relative on unit-scale values."""
    from bauklank.engine.spectral import (
        SpectralConfig, _band_chain_kernel, _band_chain_scan,
    )

    cfg = SpectralConfig(2, 512, 128)
    rng = np.random.default_rng(4)
    s_n, b_n, c_n = 40, cfg.bands, cfg.channels

    def cplx(*shape):
        return jnp.asarray(((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)) * 0.5
                            ).astype(np.complex64))

    pos = lambda *shape: jnp.asarray(
        np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.01)
    chain = (cplx(s_n, b_n), cplx(s_n, b_n), cplx(s_n, b_n), pos(s_n, b_n),
             cplx(s_n, b_n),
             jnp.asarray(rng.integers(0, c_n, (s_n, b_n)).astype(np.int32)),
             cplx(s_n, c_n, b_n), pos(s_n, c_n, b_n), cplx(s_n, c_n, b_n))
    compiled = jax.jit(functools.partial(_band_chain_kernel, cfg))(chain)
    interp = jax.jit(functools.partial(_band_chain_kernel, cfg,
                                       interpret=True))(chain)
    scan = jax.jit(jax.vmap(functools.partial(_band_chain_scan, cfg)))(chain)
    for other in (interp, scan):
        np.testing.assert_allclose(np.asarray(compiled), np.asarray(other),
                                   rtol=1e-4, atol=1e-4)


def test_golden_case_on_card(gpu_device):
    """One golden case through the served fidelity step on the card is
    >= 40 dB against the blob (the full matrix: benchmarks/check_golden.py
    --all)."""
    sys.path.insert(0, str(REPO_ROOT / "benchmarks"))
    import check_golden
    from golden_wasm import material

    golden = np.load(check_golden.FIXTURES)
    name, rate, semis, ch, extras = next(
        c for c in material.CASES if c[0] == "r05_stp12")
    snr = check_golden.run_file_case(golden, name, rate, semis, ch, extras)
    assert snr > check_golden.FLOOR_DB, snr
