"""The compensated prefix sum ``engine.spectral._comp_cumsum`` (an XLA
``associative_scan`` of double-float32 pairs).

Pins the contracts the peaks map relies on:

1. ~49-bit accuracy vs an f64 cumsum on adversarial magnitudes (the
   property the compensation exists for — plain f32 prefix differences
   cancel catastrophically);
2. gap constancy: a run of exact zeros leaves the (hi, lo) pair bitwise
   unchanged — the identity the peaks map's halved boundary lookup relies
   on (cs[end_pos[s]] == cs[start_pos[s+1]-1]);
3. band counts off any power of two, on the band axis of the [N, B, K]
   serving layout and on other axes;
4. the result is the associative_scan of ``_df_combine`` itself (the one
   form, on every backend).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bauklank.engine import spectral


@pytest.fixture(scope="module")
def adversarial():
    rng = np.random.default_rng(7)
    # huge dynamic range + an exact-zero gap + a 0/1 integer channel —
    # the three channel regimes the peaks map feeds (w, w*b, run_start),
    # in the serving layout [N, B, K]
    x = rng.standard_normal((16, 700, 3)).astype(np.float32)
    x[..., 0] *= np.exp2(rng.integers(-60, 60, (16, 700))).astype(np.float32)
    x[:, 100:200, 1] = 0.0
    x[..., 2] = rng.integers(0, 2, (16, 700)).astype(np.float32)
    return x


def _cumsum(x, axis=1):
    return jax.jit(lambda a: spectral._comp_cumsum(a, axis=axis))(
        jnp.asarray(x))


def test_accuracy_vs_f64(adversarial):
    hi, lo = _cumsum(adversarial)
    f64 = np.cumsum(adversarial.astype(np.float64), axis=1)
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    rel = np.abs(got - f64) / np.maximum(np.abs(f64), 1e-30)
    assert rel.max() < 1e-9  # ~49-bit pairs; plain f32 would be ~1e-2 here
    plain = np.cumsum(adversarial, axis=1, dtype=np.float32).astype(np.float64)
    assert (np.abs(plain - f64) / np.maximum(np.abs(f64), 1e-30)).max() > 1e-6


def test_gap_constancy(adversarial):
    hi, lo = _cumsum(adversarial)
    # channel 1 is zero over bands [100, 200): the pair must be frozen
    np.testing.assert_array_equal(np.asarray(hi)[:, 99, 1],
                                  np.asarray(hi)[:, 199, 1])
    np.testing.assert_array_equal(np.asarray(lo)[:, 99, 1],
                                  np.asarray(lo)[:, 199, 1])


@pytest.mark.parametrize("shape,axis", [((3, 300, 2), 1), ((5, 37), 1),
                                        ((37, 4), 0)])
def test_odd_lengths_and_axes(shape, axis):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    hi, lo = _cumsum(x, axis)
    assert hi.shape == lo.shape == x.shape
    f64 = np.cumsum(x.astype(np.float64), axis=axis)
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_allclose(got, f64, rtol=1e-9, atol=1e-12)


def test_is_the_associative_scan_of_df_combine():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((4, 64, 3)).astype(np.float32))
    hi, lo = spectral._comp_cumsum(x, axis=1)
    rhi, rlo = jax.lax.associative_scan(
        spectral._df_combine, (x, jnp.zeros_like(x)), axis=1)
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(rhi))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(rlo))
