"""Frequency band mapping with tonality limit, and unit-phase helpers.

Reproduces the control semantics of the reference's transpose exports
``_setTransposeFactor(factor, tonalityLimit)`` /
``_setTransposeSemitones(semitones, tonalityHz/sampleRate)``
(reference: app/SignalsmithStretch.mjs:471-472, call site :847):

- below the tonality limit, frequencies are *multiplied* by the transpose
  factor (harmonic content transposes musically);
- above it, frequencies are *offset* by a constant so the mapping stays
  continuous and noisy highs keep their character instead of being smeared
  upward/downward.

All functions are elementwise over a band axis and batch over leading axes;
transpose factor / tonality limit are traced scalars (per-stream dynamic).
Frequencies are normalized to cycles/sample (Nyquist = 0.5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "effective_tonality_limit",
    "map_freq",
    "unmap_freq",
    "source_positions",
    "interp_matrix",
    "gather_fractional",
    "gather_fractional_real",
    "unit",
]

_EPS = 1e-12


def effective_tonality_limit(factor: jnp.ndarray, tonality: jnp.ndarray) -> jnp.ndarray:
    """Split the tonality limit between input and output frequency space.

    ``limit = tonality / sqrt(factor)`` (geometric compromise so the limit
    holds approximately in both domains); ``tonality <= 0`` disables the
    limit (treated as Nyquist).
    """
    factor = jnp.maximum(factor, _EPS)
    lim = tonality * jax_rsqrt(factor)
    return jnp.where(tonality > 0, lim, 0.5)


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


def map_freq(freq_in, factor, limit):
    """Input frequency -> output frequency (multiply below limit, offset above)."""
    return jnp.where(
        freq_in <= limit,
        freq_in * factor,
        freq_in + limit * (factor - 1.0),
    )


def unmap_freq(freq_out, factor, limit):
    """Output frequency -> source input frequency (inverse of map_freq)."""
    return jnp.where(
        freq_out <= limit * factor,
        freq_out / jnp.maximum(factor, _EPS),
        freq_out - limit * (factor - 1.0),
    )


def source_positions(band_freqs: jnp.ndarray, factor, limit, block: int):
    """Fractional input-band position and frequency offset for each output band.

    band_freqs: [bins] output band centers ((k+0.5)/block)
    returns (pos [..., bins] float32 fractional input band index,
             dfreq [..., bins] float32 = f_out - f_in in cycles/sample)
    """
    f_in = unmap_freq(band_freqs, factor, limit)
    pos = f_in * block - 0.5
    return pos.astype(jnp.float32), (band_freqs - f_in).astype(jnp.float32)


def _interp_real(x: jnp.ndarray, pos: jnp.ndarray, oob: str, tile: int, window: int) -> jnp.ndarray:
    """Fractional linear-interpolation read along the last axis, as matmuls.

    The output band axis is split into tiles; each tile dynamic-slices a
    bounded input window (positions are monotone, so a tile's sources are
    contiguous) and multiplies by a small comparison-built interpolation
    matrix.  Memory is O(bins * window), not O(bins^2).

    Precision: HIGHEST is full f32 on the GPU.  The interpolation weights
    are not 0/1, so any lower setting (TF32's 10-bit mantissa on the H100)
    would round them and the data.

    x: [..., bins] real; pos: [bins_out] monotone-nondecreasing positions.
    ``oob='zero'`` reads out-of-range positions as 0 (spectrum semantics);
    ``oob='clamp'`` clamps to the edge (envelope semantics).
    """
    bins = x.shape[-1]
    bo = pos.shape[0]
    pos = pos.astype(jnp.float32)
    if oob == "clamp":
        pos = jnp.clip(pos, 0.0, float(bins - 1))

    if bo < tile or window >= bins:
        # small-problem fallback: one full matrix
        i0 = jnp.floor(pos).astype(jnp.int32)
        w = pos - i0
        ii = jnp.arange(bins, dtype=jnp.int32)
        m = (ii[:, None] == i0[None, :]) * (1.0 - w)[None, :] + (
            ii[:, None] == (i0 + 1)[None, :]
        ) * w[None, :]
        return jnp.einsum(
            "...i,io->...o", x, m.astype(x.dtype), precision=jax.lax.Precision.HIGHEST
        )

    pad_out = (-bo) % tile
    pos_p = jnp.pad(pos, (0, pad_out))
    n_tiles = pos_p.shape[0] // tile
    pos_t = pos_p.reshape(n_tiles, tile)

    # Per-tile input window start (clamped so the slice stays in range).
    starts = jnp.floor(pos_t[:, 0]).astype(jnp.int32) - 1
    starts = jnp.clip(starts, 0, max(bins - window, 0))

    def slice_win(s):
        return jax.lax.dynamic_slice_in_dim(x, s, window, axis=-1)

    wins = jax.vmap(slice_win)(starts)  # [n_tiles, ..., window]

    rel = pos_t - starts[:, None].astype(jnp.float32)  # [n_tiles, tile]
    i0 = jnp.floor(rel).astype(jnp.int32)
    w = rel - i0
    glob = starts[:, None] + i0  # [n_tiles, tile] global source index
    ww = jnp.arange(window, dtype=jnp.int32)  # [window]
    valid0 = (glob >= 0) & (glob < bins)
    valid1 = (glob + 1 >= 0) & (glob + 1 < bins)
    m = (ww[None, :, None] == i0[:, None, :]) * ((1.0 - w) * valid0)[:, None, :] + (
        ww[None, :, None] == (i0 + 1)[:, None, :]
    ) * (w * valid1)[:, None, :]  # [n_tiles, window, tile]

    out = jnp.einsum(
        "t...w,twj->...tj", wins, m.astype(x.dtype), precision=jax.lax.Precision.HIGHEST
    )
    out = out.reshape(x.shape[:-1] + (n_tiles * tile,))
    return out[..., :bo]


def gather_fractional(
    spec: jnp.ndarray, pos: jnp.ndarray, tile: int = 128, window: int = 768
) -> jnp.ndarray:
    """Complex linear interpolation of spectra at fractional band positions.

    spec: [..., bins] complex; pos: [bins_out] float, monotone.
    Out-of-range positions read as 0.  Runs as real matmuls.

    ``window`` bounds how many input bands one 128-band output tile may read
    (window/tile ~= max downward transpose factor + guard): the default 768
    covers transposition down to about -28 semitones, beyond the reference
    UI's ±24 range (app/multi/index.html:99).
    """
    parts = jnp.stack([jnp.real(spec), jnp.imag(spec)], axis=0)
    out = _interp_real(parts, pos, "zero", tile, window)
    return jax.lax.complex(out[0], out[1]).astype(jnp.complex64)


def gather_fractional_real(
    x: jnp.ndarray, pos: jnp.ndarray, oob: str = "clamp", tile: int = 128, window: int = 768
) -> jnp.ndarray:
    """Linear interpolation of a real array along the last axis (as matmuls)."""
    return _interp_real(x, pos, oob, tile, window)


def unit(z: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """z / |z| with a graceful zero limit (-> 1+0j as |z| -> 0).

    Adding eps to the real part before normalizing means silent bands yield
    the identity rotation instead of NaN, which doubles as the phase-reset
    rule: after silence, output phase restarts from the input phase.
    """
    zr = z + eps
    return zr / jnp.abs(zr)
