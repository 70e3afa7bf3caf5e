"""Offline stretch driver: whole-track rendering via chunked hop batches.

BASELINE configs 1-3 (fixed-rate, rate-sweep, stretch+pitch offline renders)
run through here.  The driver slices the output timeline into fixed-size hop
chunks, computes per-hop input positions host-side (or from a rate schedule)
and calls the jitted :func:`bauklank.engine.core.process_chunk`, carrying
engine state between chunks.  One compiled executable serves any track
length at a given config.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.config import StretchConfig
from bauklank.engine.core import init_state, process_chunk
from bauklank.engine.params import StretchParams

__all__ = ["stretch_offline", "frame_ends_for", "CHUNK_HOPS"]

CHUNK_HOPS = 64  # hops per dispatch: balances FFT batch size vs memory


def frame_ends_for(config: StretchConfig, out_start: int, n_hops: int, rate, in_start: float = 0.0):
    """Input analysis-frame end positions for hops covering output samples
    ``[out_start, out_start + n_hops * interval)`` at a fixed rate.

    Alignment contract (see :func:`process_chunk`): hop ``h``'s output frame
    center is ``out_start + h*I + B/2``; its input center is
    ``in_start + (out_start + h*I + B/2) * rate``; the frame end is the
    center + B/2.  At rate=1, in_start=0 this reduces to ``h*I + B`` —
    sample-exact identity.
    """
    b, i = config.block, config.interval
    h = np.arange(n_hops, dtype=np.float64)
    centers = np.asarray(in_start, np.float64) + (out_start + h * i + b / 2.0) * np.asarray(rate, np.float64)
    return np.round(centers).astype(np.int64) + b // 2


@functools.partial(jax.jit, static_argnums=(0,))
def _chunk_jit(config, state, audio, frame_ends, params):
    return process_chunk(config, state, audio, frame_ends, params)


@functools.partial(jax.jit, static_argnums=(0,))
def _render_all_jit(config, state, audio, ends_all, params):
    """Whole-track render as ONE dispatch: lax.scan over chunk hop-tables.

    One dispatch instead of one per chunk matters wherever host<->device
    round trips are expensive (remote-attached accelerators); compute is
    identical to chunked process_chunk calls.
    """

    def body(st, ends):
        st, out = process_chunk(config, st, audio, ends, params)
        return st, out

    state, outs = jax.lax.scan(body, state, ends_all)  # outs [N, C, H*I]
    return state, outs


def stretch_offline(
    audio: np.ndarray | jnp.ndarray,
    rate: float,
    config: StretchConfig,
    params: StretchParams | None = None,
    n_out: int | None = None,
    chunk_hops: int = CHUNK_HOPS,
) -> np.ndarray:
    """Render a whole track at a fixed stretch rate (+ params pitch/formant).

    audio: [C, T] float32.  rate: input samples per output sample (0.5 =
    2x longer, 2.0 = 2x shorter — reference UI range 0-2,
    app/multi/index.html:86).  Returns [C, n_out] float32.
    """
    audio = jnp.asarray(audio, jnp.float32)
    assert audio.ndim == 2 and audio.shape[0] == config.channels, audio.shape
    t_in = audio.shape[1]
    if n_out is None:
        n_out = int(round(t_in / max(rate, 1e-9)))
    if params is None:
        params = StretchParams.make(rate=rate)

    i = config.interval
    total_hops = -(-n_out // i)
    # bigger hop batches utilize the chip far better for offline renders;
    # bounded so frame tensors stay within memory
    chunk_hops = max(chunk_hops, min(512, total_hops))
    n_chunks = -(-total_hops // chunk_hops)
    # bucket the chunk count (powers of two) so the one-dispatch renderer
    # compiles per bucket, not per track length; surplus chunks read past
    # the track (zero frames) and are sliced away
    bucket = 1
    while bucket < n_chunks:
        bucket *= 2

    ends_all = np.stack(
        [frame_ends_for(config, ci * chunk_hops * i, chunk_hops, rate) for ci in range(bucket)]
    )
    state = init_state(config)
    _, outs = _render_all_jit(
        config, state, audio, jnp.asarray(ends_all, jnp.int32), params
    )  # [bucket, C, H*I]
    y = jnp.moveaxis(outs, 0, 1).reshape(config.channels, -1)[:, :n_out]
    return np.asarray(y)
