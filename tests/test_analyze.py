"""Scope/analyzer ops."""

import numpy as np

import jax.numpy as jnp

from tests.util import tone

from bauklank.ops.analyze import levels, scope_buckets, spectrum_db

SR = 44100.0


def test_scope_buckets_envelope():
    x = jnp.asarray(np.linspace(-1, 1, 1000, dtype=np.float32))
    b = np.asarray(scope_buckets(x, 10))
    assert b.shape == (10, 2)
    assert (b[:, 0] <= b[:, 1]).all()
    np.testing.assert_allclose(b[0, 0], -1.0, atol=1e-3)
    np.testing.assert_allclose(b[-1, 1], 1.0, atol=1e-2)


def test_spectrum_db_peak_at_tone():
    x = jnp.asarray(tone(1000.0, 16384, SR))
    db = np.asarray(spectrum_db(x, n_fft=2048))
    assert db.shape == (1025,)
    peak_bin = int(np.argmax(db))
    assert abs(peak_bin * SR / 2048 - 1000.0) < 30.0
    # ~unit-amplitude sine peaks near -6 dBFS-ish in this normalization
    assert db[peak_bin] > -10.0
    assert np.median(db) < -60.0


def test_levels():
    x = jnp.asarray(np.stack([tone(500.0, 8192, SR), 0.5 * tone(500.0, 8192, SR)]))
    lv = levels(x)
    rms = np.asarray(lv["rms"])
    peak = np.asarray(lv["peak"])
    np.testing.assert_allclose(rms[0], 1 / np.sqrt(2), atol=0.01)
    np.testing.assert_allclose(peak[1], 0.5, atol=0.01)
