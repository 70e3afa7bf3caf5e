"""Frame gather and overlap-add — the time<->frame boundary ops.

The reference engine walks hops one at a time in a scalar C++ loop inside the
WASM blob, re-reading a latency-sized input window every render quantum
(reference: app/SignalsmithStretch.mjs:891-936).  Here both directions are
batched tensor ops over ``[channels, hops, block]`` so XLA can tile them.

Frames are fetched with a vmapped ``lax.dynamic_slice`` (one contiguous
``block``-sample read per frame) over a zero-padded copy of the signal; padding (one
block + one interval on each side) makes every partially-out-of-range frame
land on real zeros with correct alignment, and a cheap per-frame mask kills
fully-out-of-range frames (the reference zero-pads its seek window the same
way — app/SignalsmithStretch.mjs:905-931).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["gather_frames", "overlap_add", "ola_chunks"]


def gather_frames(signal: jnp.ndarray, starts: jnp.ndarray, block: int) -> jnp.ndarray:
    """Gather zero-padded frames.

    signal: [C, T] real
    starts: [H] int32 — frame start sample per hop
    returns [C, H, block]
    """
    c, t = signal.shape
    pad = block
    padded = jnp.pad(signal, ((0, 0), (pad, pad)))

    def slice_one(st):
        return jax.lax.dynamic_slice(padded, (0, st + pad), (c, block))

    frames = jax.vmap(slice_one, out_axes=1)(starts.astype(jnp.int32))  # [C, H, B]
    # dynamic_slice clamps starts into [-pad, t + pad - block]; every frame
    # overlapping [0, t) is alignment-correct thanks to the zero padding.
    # Frames fully outside get arbitrary clamped content — mask them.
    valid = (starts > -block) & (starts < t)
    return frames * valid[None, :, None]


def overlap_add(frames: jnp.ndarray, interval: int, out_len: int) -> jnp.ndarray:
    """Overlap-add frames placed at ``h * interval``.

    frames: [..., H, B] (already synthesis-windowed)
    returns [..., out_len]

    Implemented as a diagonal sum over ``K = ceil(B / interval)`` interval-
    sized chunks: output chunk ``j`` receives ``sum_k frames[j - k, k]``.
    ``K`` is small (overlap <= 8 in the public config surface — reference UI
    range app/multi/index.html:86-182), so the Python loop unrolls into a few
    fused adds instead of a scatter.
    """
    h = frames.shape[-2]
    b = frames.shape[-1]
    k = -(-b // interval)  # ceil
    pad = k * interval - b
    if pad:
        frames = jnp.pad(frames, [(0, 0)] * (frames.ndim - 1) + [(0, pad)])
    parts = frames.reshape(frames.shape[:-1] + (k, interval))  # [..., H, K, I]
    total_chunks = h + k  # covers h*I + B samples, padded
    out = jnp.zeros(frames.shape[:-2] + (total_chunks * interval,), frames.dtype)
    for kk in range(k):
        seg = parts[..., kk, :].reshape(frames.shape[:-2] + (h * interval,))
        out = out.at[..., kk * interval : (kk + h) * interval].add(seg)
    if out.shape[-1] < out_len:
        out = jnp.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, out_len - out.shape[-1])])
    return out[..., :out_len]


def ola_chunks(frames: jnp.ndarray, interval: int) -> jnp.ndarray:
    """Streaming OLA helper: fold one block into interval-sized diagonals.

    frames: [..., B] (one hop, windowed) -> [..., K, interval] where row k is
    the contribution to the k-th future interval-chunk.  The engine keeps a
    ``[..., K, interval]`` tail; per hop it emits row 0 + the shifted tail.
    """
    b = frames.shape[-1]
    k = -(-b // interval)
    pad = k * interval - b
    if pad:
        frames = jnp.pad(frames, [(0, 0)] * (frames.ndim - 1) + [(0, pad)])
    return frames.reshape(frames.shape[:-1] + (k, interval))
