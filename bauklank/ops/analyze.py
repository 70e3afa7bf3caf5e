"""Monitoring analysis ops: oscilloscope buckets, spectrum, level meters.

The batched equivalent of the reference's (disabled) Scope visualizer —
a second WASM AudioWorklet computing oscilloscope/spectrum frames for an
iframe UI (reference: app/Scope.mjs:362, 440-610; gated off at
app/app.mjs:50).  Here the same measurements are cheap batched tensor ops a
monitoring client can request over the control plane.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["scope_buckets", "spectrum_db", "levels"]


def scope_buckets(signal: jnp.ndarray, n_buckets: int) -> jnp.ndarray:
    """Min/max envelope per display bucket (oscilloscope rendering).

    signal: [..., T] -> [..., n_buckets, 2] (min, max per bucket).
    """
    t = signal.shape[-1]
    per = t // n_buckets
    x = signal[..., : per * n_buckets].reshape(signal.shape[:-1] + (n_buckets, per))
    return jnp.stack([jnp.min(x, axis=-1), jnp.max(x, axis=-1)], axis=-1)


def spectrum_db(signal: jnp.ndarray, n_fft: int = 2048, floor_db: float = -120.0) -> jnp.ndarray:
    """Averaged magnitude spectrum in dB over Hann-windowed frames.

    signal: [..., T] -> [..., n_fft//2 + 1]
    """
    t = signal.shape[-1]
    hop = n_fft // 2
    n_frames = max(1, (t - n_fft) // hop + 1)
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(n_fft)[None, :]
    frames = signal[..., idx]  # [..., n_frames, n_fft]
    win = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(n_fft) / n_fft)
    spec = jnp.fft.rfft(frames * win, axis=-1)
    power = jnp.mean(jnp.abs(spec) ** 2, axis=-2)
    ref = (jnp.sum(win) / 2.0) ** 2
    db = 10.0 * jnp.log10(jnp.maximum(power / ref, 10.0 ** (floor_db / 10.0)))
    return db


def levels(signal: jnp.ndarray) -> dict:
    """Per-channel rms and peak (dBFS-able raw linear values).

    signal: [..., T] -> {"rms": [...], "peak": [...]}
    """
    return {
        "rms": jnp.sqrt(jnp.mean(jnp.square(signal), axis=-1)),
        "peak": jnp.max(jnp.abs(signal), axis=-1),
    }
