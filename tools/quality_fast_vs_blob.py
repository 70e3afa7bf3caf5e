"""Score the FAST engine (engine.core) against the reference-blob fixtures.

The fast engine is this project's own hop-parallel phase-vocoder spec — not
the reverse-engineered blob algorithm (that is engine.spectral/fidelity).
Its fidelity evidence was previously only vs refdsp (an independent
implementation of the same invented spec); this script closes the
evidentiary hole (VERDICT r2 weak #1 / next #2) by scoring it against the
committed renders of the ACTUAL reference WASM blob
(tests/golden/golden_v1.npz; blob at reference app/SignalsmithStretch.mjs:
265, executed via tools/golden_wasm).

Because the two engines are different phase-vocoder designs, raw
time-domain SNR mostly measures PHASE divergence; the table therefore
reports, per golden case:

- ``lag``: the best integer alignment lag (the engines report latency
  differently; alignment is part of honest comparison),
- ``time SNR``: time-domain SNR after that alignment,
- ``mag SNR``: spectral-magnitude SNR over aligned STFT frames (hann 4096,
  hop 1024) — phase-blind; measures whether the two renders put the same
  energy at the same frequencies at the same times,
- ``LSD``: log-spectral distance (dB RMS over active bins), the classic
  perceptual-envelope distance.

Run: ``JAX_PLATFORMS=cpu python tools/quality_fast_vs_blob.py [--json]``
(CPU-runnable; the fixtures make the blob side compiler-free).
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from golden_wasm import material  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent.parent / "tests" / "golden" / "golden_v1.npz"


def _mono(x: np.ndarray) -> np.ndarray:
    return x.mean(axis=0) if x.ndim == 2 else x


def best_lag(ref: np.ndarray, got: np.ndarray, max_lag: int = 12000) -> int:
    """Integer lag (got delayed by `lag` relative to ref) maximizing
    cross-correlation, via one FFT correlation."""
    a, b = _mono(ref), _mono(got)
    n = 1 << int(np.ceil(np.log2(a.size + b.size)))
    corr = np.fft.irfft(np.fft.rfft(a, n) * np.conj(np.fft.rfft(b, n)), n)
    lags = np.concatenate([np.arange(0, max_lag), np.arange(-max_lag, 0)])
    vals = np.concatenate([corr[:max_lag], corr[-max_lag:]])
    return int(lags[np.argmax(vals)])


def aligned(ref: np.ndarray, got: np.ndarray, lag: int, skip: int):
    """Overlapping region after delaying `got` by `lag` (may be negative)."""
    if lag >= 0:
        r, g = ref[..., lag:], got[..., : got.shape[-1] - lag]
    else:
        r, g = ref[..., : ref.shape[-1] + lag], got[..., -lag:]
    n = min(r.shape[-1], g.shape[-1])
    return r[..., skip:n], g[..., skip:n]


def time_snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(
        10 * np.log10(np.mean(ref**2) / max(np.mean((ref - got) ** 2), 1e-30))
    )


def _stft_mag(x: np.ndarray, n_fft: int = 4096, hop: int = 1024) -> np.ndarray:
    w = np.hanning(n_fft)
    n_frames = max(0, (x.shape[-1] - n_fft) // hop + 1)
    frames = np.stack([x[i * hop : i * hop + n_fft] * w for i in range(n_frames)])
    return np.abs(np.fft.rfft(frames, axis=-1))


def mag_snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    """Phase-blind spectral SNR over aligned STFT magnitude frames."""
    mr, mg = _stft_mag(_mono(ref)), _stft_mag(_mono(got))
    return float(
        10 * np.log10(np.sum(mr**2) / max(np.sum((mr - mg) ** 2), 1e-30))
    )


def lsd_db(ref: np.ndarray, got: np.ndarray, floor_db: float = -80.0) -> float:
    """Log-spectral distance: RMS dB difference over bins that carry energy
    in the reference (> floor relative to the frame peak)."""
    mr, mg = _stft_mag(_mono(ref)), _stft_mag(_mono(got))
    eps = 1e-12
    lr = 20 * np.log10(mr + eps)
    lg = 20 * np.log10(mg + eps)
    active = lr > (lr.max() + floor_db)
    d = (lr - lg)[active]
    return float(np.sqrt(np.mean(d**2)))


def score_case(golden, name, rate, semitones, channels, extras) -> dict:
    from bauklank.engine.config import StretchConfig
    from bauklank.engine.offline import stretch_offline
    from bauklank.engine.params import StretchParams

    sr = material.SR
    rex = material.renderer_extras(extras)
    cfg = StretchConfig(
        channels=channels,
        block=round(material.BLOCK_MS / 1000 * sr),
        interval=round(material.INTERVAL_MS / 1000 * sr),
        formants=bool(rex),
    )
    params = StretchParams.make(
        rate=rate,
        semitones=semitones,
        tonality_hz=material.TONALITY_HZ,
        formant_semitones=rex.get("formant_semitones", 0.0),
        formant_compensation=1.0 if rex.get("formant_compensation") else 0.0,
        formant_base_hz=rex.get("formant_base_hz", 0.0),
        sample_rate=sr,
    )
    x = material.case_input(rate, channels)
    n_out = int(material.SECONDS * sr)
    got = stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    ref = np.asarray(golden[name][..., :n_out])
    end = int(extras.get("_compare_sec", material.SECONDS) * sr)
    ref, got = ref[..., :end], got[..., :end]
    skip = round(material.BLOCK_MS / 1000 * sr)
    lag = best_lag(ref, got)
    r, g = aligned(ref, got, lag, skip)
    return {
        "case": name,
        "lag": lag,
        "time_snr_db": round(time_snr_db(r, g), 1),
        "mag_snr_db": round(mag_snr_db(r, g), 1),
        "lsd_db": round(lsd_db(r, g), 2),
    }


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    golden = np.load(FIXTURES)
    rows = []
    for case in material.CASES:
        rows.append(score_case(golden, *case))
        print(rows[-1], file=sys.stderr)
    if "--json" in sys.argv:
        print(json.dumps(rows))
        return
    print("| case | lag (smp) | time SNR (dB) | mag SNR (dB) | LSD (dB) |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['case']} | {r['lag']} | {r['time_snr_db']} "
            f"| {r['mag_snr_db']} | {r['lsd_db']} |"
        )


if __name__ == "__main__":
    main()
