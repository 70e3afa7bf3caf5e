"""Objective quality report across the control-parameter matrix.

For a battery of (rate, semitones, formant) settings, renders test material
through the engine and reports:

- SNR vs the independent scalar reference renderer (implementation
  correctness — should be high everywhere);
- tone frequency accuracy (cents error of a shifted/stretched sine);
- worst frame-rate sideband level for a shifted tone (phase-coherence
  quality; see engine.core's lobe-consistent correction);
- broadband energy preservation for noise content.

Usage:  JAX_PLATFORMS=cpu python tools/quality_report.py [--quick]
Emits a markdown table on stdout.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    if os.environ.get("JAX_PLATFORMS"):
        import jax

        try:
            jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
        except RuntimeError:
            pass

    from bauklank.engine import StretchConfig, StretchParams, stretch_offline
    from bauklank.refdsp import render_offline

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--interval", type=int, default=256)
    args = ap.parse_args(argv)

    sr = 44100.0
    n_in = int((2.0 if args.quick else 4.0) * sr)
    n_out = 16384 if args.quick else 49152
    rng = np.random.default_rng(0)
    t = np.arange(n_in) / sr
    tone440 = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    noise = (rng.standard_normal(n_in) * 0.25).astype(np.float32)
    mix = (0.5 * tone440 + 0.3 * np.sin(2 * np.pi * 1318.5 * t) + 0.1 * noise).astype(np.float32)

    def spec_peak(seg):
        w = np.hanning(len(seg))
        spec = np.abs(np.fft.rfft(seg * w))
        freqs = np.fft.rfftfreq(len(seg), 1 / sr)
        k = int(np.argmax(spec))
        # parabolic interpolation on log magnitude: the raw peak bin is
        # ~21 cents wide at 440 Hz for an 8192-point FFT, far coarser than
        # the sub-cent detune being measured
        if 0 < k < len(spec) - 1:
            la, lb, lc = np.log(np.maximum(spec[k - 1 : k + 2], 1e-30))
            denom = la - 2 * lb + lc
            delta = 0.5 * (la - lc) / denom if abs(denom) > 1e-12 else 0.0
            return (k + float(np.clip(delta, -0.5, 0.5))) * (freqs[1] - freqs[0]), spec, freqs
        return freqs[k], spec, freqs

    matrix = [(r, s) for r in (0.5, 1.0, 2.0) for s in (-12, 0, 12)]
    if args.quick:
        matrix = [(0.5, 12), (1.0, 0), (2.0, -12)]

    print("| rate | semis | SNR vs refdsp (dB) | tone err (cents) | worst sideband (dB) | noise energy (dB) |")
    print("|---|---|---|---|---|---|")
    for rate, semis in matrix:
        cfg = StretchConfig(channels=1, block=args.block, interval=args.interval, formants=False)
        params = StretchParams.make(rate=rate, semitones=semis, tonality_hz=8000.0, sample_rate=sr)
        tf = 2.0 ** (semis / 12.0)

        # SNR vs scalar renderer (mixed material)
        got = stretch_offline(mix[None], rate, cfg, params=params, n_out=n_out)
        want = render_offline(mix[None].astype(np.float64), rate, cfg, n_out,
                              transpose_factor=tf, tonality=8000.0 / sr)
        a, b = want[:, cfg.block:], got[:, cfg.block:]
        snr = 10 * np.log10(np.mean(a**2) / max(np.mean((a - b) ** 2), 1e-30))

        # tone accuracy + sidebands
        yt = stretch_offline(tone440[None], rate, cfg, params=params, n_out=n_out)[0]
        seg = yt[cfg.block * 3 : cfg.block * 3 + 8192]
        fpk, spec, freqs = spec_peak(seg)
        want_f = 440.0 * tf
        cents = 1200 * np.log2(max(fpk, 1.0) / want_f)
        fr = sr / cfg.interval

        def mag_at(f):
            i = int(np.argmin(np.abs(freqs - f)))
            return spec[max(0, i - 2) : i + 3].max()

        sb = 20 * np.log10(
            max(mag_at(want_f - fr), mag_at(want_f + fr)) / max(mag_at(want_f), 1e-12)
        )

        # noise energy preservation
        yn = stretch_offline(noise[None], rate, cfg, params=params, n_out=n_out)[0]
        e = 10 * np.log10(np.mean(yn[cfg.block * 2 :] ** 2) / np.mean(noise**2))

        print(f"| {rate} | {semis:+d} | {snr:5.1f} | {cents:+6.1f} | {sb:6.1f} | {e:+5.1f} |")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
