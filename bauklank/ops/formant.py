"""Spectral-envelope (formant) estimation and shift.

Control surface mirrors the reference exports ``_setFormantSemitones(
semitones, compensation)`` / ``_setFormantFactor`` / ``_setFormantBase(
freqNormalized)`` with 0 = attempt auto-detection (reference:
app/SignalsmithStretch.mjs:473-475, call sites :848-849; behavioral
semantics narrated in README-signalsmith.md "Formant compensation" section):

- ``compensation``: keep the spectral envelope anchored while pitch moves.
- ``formant factor``: move the envelope itself by a ratio.
- ``formant base``: the fundamental-frequency scale used to smooth the
  spectrum into an envelope (harmonic spacing); 0 auto-detects per hop.

Batched formulation: the envelope is a Gaussian-smoothed power spectrum,
computed in the quefrency domain (FFT along the band axis with an
elementwise Gaussian transfer function).  The smoothing *width is a traced
scalar* — shapes stay static for any per-stream formant base, so 64+ streams
with different bases run in one batched dispatch.
"""

from __future__ import annotations

import jax.numpy as jnp

from bauklank.ops.pitchmap import gather_fractional_real, unmap_freq

__all__ = ["spectral_envelope", "detect_f0_bands", "formant_gain"]

_EPS = 1e-9


def spectral_envelope(power: jnp.ndarray, sigma_bands: jnp.ndarray) -> jnp.ndarray:
    """Gaussian-smooth a power spectrum along the last (band) axis.

    power: [..., bins] nonnegative; sigma_bands: traced scalar or [..., 1]
    smoothing std-dev in band units.  Uses reflection padding to 2*bins to
    avoid circular wrap, then an FFT-domain Gaussian.
    """
    bins = power.shape[-1]
    ext = jnp.concatenate([power, power[..., ::-1]], axis=-1)  # reflect, len 2*bins
    spec = jnp.fft.rfft(ext, axis=-1)
    q = jnp.arange(spec.shape[-1], dtype=jnp.float32)
    # Fourier transform of a Gaussian of std sigma (in samples of the band
    # axis) over period 2*bins: exp(-2 pi^2 sigma^2 q^2 / (2*bins)^2)
    sig = jnp.asarray(sigma_bands, jnp.float32)
    if sig.ndim:
        sig = sig[..., None]
    g = jnp.exp(-2.0 * (jnp.pi**2) * (sig**2) * (q**2) / float((2 * bins) ** 2))
    sm = jnp.fft.irfft(spec * g, n=2 * bins, axis=-1)[..., :bins]
    return jnp.maximum(sm, 0.0)


def detect_f0_bands(power: jnp.ndarray, max_band: int | None = None) -> jnp.ndarray:
    """Crude per-hop fundamental estimate, in band units.

    Cepstral peak over the summed log-power spectrum: FFT along bands, take
    the quefrency with maximal magnitude in a plausible range, convert to a
    band spacing.  Good enough to size the envelope smoother when the user
    passes formantBase = 0 ("attempt to detect", reference:
    app/SignalsmithStretch.mjs:597-599 timeMap default comment).

    power: [..., bins] -> f0 in band units, shape [...]
    """
    bins = power.shape[-1]
    logp = jnp.log(power + _EPS)
    ceps = jnp.abs(jnp.fft.rfft(logp, axis=-1))  # [..., bins//2+1]
    qn = ceps.shape[-1]
    q = jnp.arange(qn, dtype=jnp.float32)
    # Quefrency q corresponds to harmonic spacing bins/q; restrict to
    # spacings between ~2 bands and bins/8 (i.e. q in [8, bins/2]).
    lo, hi = 8.0, bins / 2.0
    mask = (q >= lo) & (q <= hi)
    masked = jnp.where(mask, ceps, -jnp.inf)
    qpk = jnp.argmax(masked, axis=-1).astype(jnp.float32)
    spacing = bins / jnp.maximum(qpk, 1.0)
    if max_band is None:
        max_band = bins // 4
    return jnp.clip(spacing, 1.0, float(max_band))


def formant_gain(
    env: jnp.ndarray,
    band_freqs: jnp.ndarray,
    source_pos: jnp.ndarray,
    formant_factor,
    compensation,
    transpose_factor,
    tonality_limit,
    block: int,
    max_gain: float = 16.0,
) -> jnp.ndarray:
    """Per-band magnitude gain realizing the formant controls.

    env:          [..., bins] input spectral envelope (power domain)
    band_freqs:   [bins] output band centers (cycles/sample)
    source_pos:   [..., bins] fractional input band of each output band
                  (what the pitch mapper reads — its envelope is the
                  *natural* post-shift envelope)
    formant_factor / compensation / transpose_factor / tonality_limit:
                  traced per-stream scalars (compensation as 0/1 float)

    Target envelope position:
      compensation on :  f_out / formant_factor          (anchored envelope)
      compensation off:  unmap(f_out / formant_factor)   (envelope rides the
                                                          pitch shift)
    Gain = sqrt(target_env / natural_env), clipped.  With formant_factor = 1
    and compensation off this is exactly 1 (no spectral coloration).
    """
    ff = jnp.maximum(jnp.asarray(formant_factor, jnp.float32), 1e-6)
    f_t = band_freqs / ff
    f_uncomp = unmap_freq(f_t, transpose_factor, tonality_limit)
    comp = jnp.asarray(compensation, jnp.float32)
    f_target = comp * f_t + (1.0 - comp) * f_uncomp
    pos_t = f_target * block - 0.5

    env_nat = gather_fractional_real(env, source_pos, oob="clamp")
    env_tgt = gather_fractional_real(env, pos_t, oob="clamp")
    gain = jnp.sqrt((env_tgt + _EPS) / (env_nat + _EPS))
    return jnp.clip(gain, 0.0, max_gain)
