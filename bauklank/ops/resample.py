"""Fractional-rate resampling (batched cubic Lagrange interpolation).

The BASELINE north star names "fractional-rate pitch resampling" as one of
the kernels to rebuild.  The spectral pitch mapper
(:mod:`bauklank.ops.pitchmap`) is the primary pitch path (matching the
reference engine's transpose exports); this resampler provides the
complementary "resample + stretch" pitch mode and general rate conversion
for the I/O layer.

Static shapes: the caller fixes the output length; positions are computed
from a traced ratio, out-of-range reads are zero.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["resample"]


def resample(signal: jnp.ndarray, ratio, out_len: int, start: float | jnp.ndarray = 0.0) -> jnp.ndarray:
    """Read ``signal`` at positions ``start + j * ratio`` with cubic Lagrange.

    signal: [..., T];  ratio: traced scalar or [..., 1] input-samples per
    output-sample;  returns [..., out_len].
    """
    t = signal.shape[-1]
    j = jnp.arange(out_len, dtype=jnp.float32)
    ratio = jnp.asarray(ratio, jnp.float32)
    if ratio.ndim:
        pos = jnp.asarray(start, jnp.float32)[..., None] + j * ratio
    else:
        pos = jnp.asarray(start, jnp.float32) + j * ratio
    i1 = jnp.floor(pos).astype(jnp.int32)
    f = (pos - i1).astype(jnp.float32)

    # 4-tap Lagrange weights around i1 (taps at i1-1, i1, i1+1, i1+2).
    w_m1 = -f * (f - 1.0) * (f - 2.0) / 6.0
    w_0 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0
    w_p1 = -(f + 1.0) * f * (f - 2.0) / 2.0
    w_p2 = (f + 1.0) * f * (f - 1.0) / 6.0

    batch_shape = jnp.broadcast_shapes(signal.shape[:-1], pos.shape[:-1])
    sig = jnp.broadcast_to(signal, batch_shape + (t,))

    def tap(offset):
        idx = i1 + offset
        valid = (idx >= 0) & (idx < t)
        clipped = jnp.clip(idx, 0, t - 1)
        v = jnp.take_along_axis(sig, jnp.broadcast_to(clipped, batch_shape + clipped.shape[-1:]), axis=-1)
        return jnp.where(valid, v, 0.0)

    out = w_m1 * tap(-1) + w_0 * tap(0) + w_p1 * tap(1) + w_p2 * tap(2)
    return out.astype(signal.dtype)
