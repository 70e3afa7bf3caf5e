"""Cross-validation: the vectorized engine must match the independent
scalar NumPy renderer sample-for-sample (high SNR)."""

import numpy as np
import pytest

from tests.util import snr_db, tone

from bauklank.engine import StretchConfig, StretchParams, stretch_offline
from bauklank.refdsp import render_offline

SR = 44100.0


def _material(n=30000):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n).astype(np.float32) * 0.1
    x += tone(440.0, n, SR) * 0.3 + tone(1234.5, n, SR) * 0.2
    return x[None, :]


def test_engine_matches_scalar_renderer_overlap1():
    """The deployed kiosk runs overlap 1 (interval == block); the engine and
    the scalar renderer must agree there too."""
    cfg = StretchConfig(channels=1, block=1024, interval=1024, formants=False)
    x = _material()
    got = stretch_offline(x, 0.6, cfg, n_out=16384,
                          params=StretchParams.make(rate=0.6, sample_rate=SR))
    want = render_offline(x.astype(np.float64), 0.6, cfg, 16384)
    s = snr_db(want[:, cfg.block :], got[:, cfg.block :])
    assert s > 45.0, s


@pytest.mark.parametrize(
    "rate,semitones,formants",
    [
        (1.0, 0, False),
        (0.7, 0, False),
        (1.6, 0, False),
        (1.0, 5, False),
        (0.8, -7, True),
        (1.0, 0, True),
    ],
)
def test_engine_matches_scalar_renderer(rate, semitones, formants):
    cfg = StretchConfig(channels=1, block=1024, interval=256, formants=formants)
    x = _material()
    n_out = 16384
    tf = 2.0 ** (semitones / 12.0)
    params = StretchParams.make(rate=rate, semitones=semitones, tonality_hz=8000.0, sample_rate=SR)
    got = stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    want = render_offline(
        x.astype(np.float64), rate, cfg, n_out,
        transpose_factor=tf, tonality=8000.0 / SR,
    )
    s = snr_db(want[:, cfg.block :], got[:, cfg.block :])
    assert s > 45.0, (rate, semitones, formants, s)


def test_engine_matches_renderer_custom_window_beta():
    """window_beta (the round-2 calibration dial) threads identically
    through the engine and the scalar spec."""
    cfg = StretchConfig(channels=1, block=1024, interval=256, formants=False,
                        window_beta=6.5)
    x = _material()
    got = stretch_offline(x, 0.75, cfg, n_out=12288,
                          params=StretchParams.make(rate=0.75, sample_rate=SR))
    want = render_offline(x.astype(np.float64), 0.75, cfg, 12288)
    s = snr_db(want[:, cfg.block :], got[:, cfg.block :])
    assert s > 45.0, s


def test_engine_matches_renderer_stereo_formant_controls():
    cfg = StretchConfig(channels=2, block=1024, interval=256, formants=True)
    x = np.stack([_material()[0], _material()[0] * 0.5])
    params = StretchParams.make(
        rate=0.9, semitones=4, tonality_hz=6000.0,
        formant_semitones=3, formant_compensation=1.0, formant_base_hz=220.0,
        sample_rate=SR,
    )
    got = stretch_offline(x, 0.9, cfg, params=params, n_out=12288)
    want = render_offline(
        x.astype(np.float64), 0.9, cfg, 12288,
        transpose_factor=2.0 ** (4 / 12.0), tonality=6000.0 / SR,
        formant_factor=2.0 ** (3 / 12.0), formant_compensation=True,
        formant_base=220.0 / SR,
    )
    s = snr_db(want[:, cfg.block :], got[:, cfg.block :])
    assert s > 40.0, s
