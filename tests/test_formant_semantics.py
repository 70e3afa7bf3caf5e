"""Behavioral formant semantics: compensation anchors the spectral envelope
while pitch moves (reference semantics: README-signalsmith.md formant
section; exports app/SignalsmithStretch.mjs:473-475)."""

import numpy as np

from bauklank.engine import StretchConfig, StretchParams, stretch_offline

SR = 44100.0


def _vowel(n):
    """Harmonics of 150 Hz shaped by formant bumps at 700/1800 Hz."""
    t = np.arange(n) / SR

    def g(f):
        return np.exp(-(((f - 700) / 250) ** 2)) + 0.7 * np.exp(-(((f - 1800) / 350) ** 2)) + 0.02

    x = sum(g(k * 150.0) * np.sin(2 * np.pi * k * 150.0 * t + 0.7 * k) for k in range(1, 60))
    return (0.25 * x / np.abs(x).max()).astype(np.float32)[None]


def _formant1_peak(y):
    seg = y[0, 3 * 2048 : 3 * 2048 + 32768]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / SR)
    lo = (freqs > 300) & (freqs < 1300)
    sm = np.convolve(spec, np.ones(50) / 50, mode="same")
    return freqs[lo][np.argmax(sm[lo])]


def test_formant_compensation_anchors_envelope():
    x = _vowel(int(2 * SR))
    cfg = StretchConfig(channels=1, block=2048, interval=512, formants=True)
    peaks = {}
    for comp in (0.0, 1.0):
        p = StretchParams.make(
            rate=1.0, semitones=12, formant_compensation=comp,
            formant_base_hz=150.0, tonality_hz=8000.0, sample_rate=SR,
        )
        y = stretch_offline(x, 1.0, cfg, params=p, n_out=int(1.5 * SR))
        peaks[comp] = _formant1_peak(y)
    # uncompensated: the 700 Hz formant rides the +12 st shift upward
    assert peaks[0.0] > 1050, peaks
    # compensated: it stays anchored near the source formant
    assert peaks[1.0] < 900, peaks


def test_formant_shift_moves_envelope_without_pitch():
    """formantSemitones moves the envelope in the commanded direction while
    harmonics stay put (absolute peak location is smeared by the 150 Hz
    harmonic comb, so the assertion is directional)."""
    x = _vowel(int(2 * SR))
    cfg = StretchConfig(channels=1, block=2048, interval=512, formants=True)
    peaks = {}
    for fs in (0, 7, -5):
        p = StretchParams.make(
            rate=1.0, semitones=0, formant_semitones=fs, formant_compensation=1.0,
            formant_base_hz=150.0, sample_rate=SR,
        )
        y = stretch_offline(x, 1.0, cfg, params=p, n_out=int(1.5 * SR))
        peaks[fs] = _formant1_peak(y)
    assert 600 < peaks[0] < 800, peaks       # neutral stays at the source formant
    assert peaks[7] > peaks[0] * 1.15, peaks  # +7 st moves it up
    assert peaks[-5] < peaks[0] * 0.92, peaks  # -5 st moves it down
