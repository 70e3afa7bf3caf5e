"""The fast engine's banded interpolation (``ops.pitchmap._interp_real``,
tiled einsums) against a dense float64 interpolation reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from bauklank.ops.pitchmap import _interp_real, gather_fractional


def _dense(x, pos, oob):
    """Linear interpolation along the last axis, float64, one full
    [bins, bins_out] weight matrix."""
    bins = x.shape[-1]
    pos = np.asarray(pos, np.float64)
    if oob == "clamp":
        pos = np.clip(pos, 0.0, bins - 1.0)
    i0 = np.floor(pos).astype(int)
    w = pos - i0
    m = np.zeros((bins, pos.shape[0]))
    for j, (i, f) in enumerate(zip(i0, w)):
        if 0 <= i < bins:
            m[i, j] += 1.0 - f
        if 0 <= i + 1 < bins:
            m[i + 1, j] += f
    return np.asarray(x, np.float64) @ m


@pytest.mark.parametrize("oob", ["zero", "clamp"])
@pytest.mark.parametrize("slope", [0.5, 1.0, 1.8])
def test_banded_matches_dense(oob, slope):
    """Monotone pitch-map positions (slope = 1/transpose factor) with
    out-of-range ends, through the tiled path (bins_out a multiple of the
    tile) against the dense reference."""
    rng = np.random.default_rng(0)
    bins = 512
    x = rng.standard_normal((3, 4, bins)).astype(np.float32)
    pos = (np.arange(bins) * slope - 3.3).astype(np.float32)
    got = np.asarray(_interp_real(jnp.asarray(x), jnp.asarray(pos), oob,
                                  128, 768))
    want = _dense(x, pos, oob)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_small_problem_fallback_matches_dense():
    """Fewer output bands than one tile takes the single-matrix form."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 100)).astype(np.float32)
    pos = np.sort(rng.uniform(-2, 102, 100)).astype(np.float32)
    got = np.asarray(_interp_real(jnp.asarray(x), jnp.asarray(pos), "zero",
                                  128, 768))
    np.testing.assert_allclose(got, _dense(x, pos, "zero"), atol=2e-5)


def test_identity_positions_copy_exactly():
    rng = np.random.default_rng(2)
    spec = (rng.standard_normal((2, 3, 256))
            + 1j * rng.standard_normal((2, 3, 256))).astype(np.complex64)
    got = np.asarray(gather_fractional(jnp.asarray(spec),
                                       jnp.arange(256, dtype=jnp.float32)))
    np.testing.assert_array_equal(got, spec)
