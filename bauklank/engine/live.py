"""Live-input processing: coupled input/output streaming.

The reference engine supports feeding live input per render quantum —
copy the quantum into the input planes and ``_process(N, N)`` (reference:
app/SignalsmithStretch.mjs:870-882) — alongside the seek-based file mode.
Here the live path keeps a device-resident input ring inside the state
pytree; each step appends one chunk (``hops * interval`` samples, static
shape), analyzes at ring positions advancing in lockstep with the output,
and reuses the same spectral core (:func:`process_chunk`) on the ring.

Pitch/formant controls apply as in file mode; the effective time rate is 1
(input consumed as fast as output is produced), matching the reference's
live behavior.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bauklank.engine.config import StretchConfig
from bauklank.engine.core import StretchState, init_state, process_chunk
from bauklank.engine.params import StretchParams

__all__ = ["LiveState", "init_live_state", "process_live"]


class LiveState(NamedTuple):
    engine: StretchState
    ring: jnp.ndarray  # [C, R] most recent input samples (R fixed)


def ring_len(config: StretchConfig, hops_per_chunk: int) -> int:
    return config.block + config.interval + hops_per_chunk * config.interval


def init_live_state(config: StretchConfig, hops_per_chunk: int = 1) -> LiveState:
    return LiveState(
        engine=init_state(config),
        ring=jnp.zeros((config.channels, ring_len(config, hops_per_chunk)), jnp.float32),
    )


@functools.partial(jax.jit, static_argnums=(0,))
def process_live(
    config: StretchConfig,
    state: LiveState,
    chunk: jnp.ndarray,
    params: StretchParams,
):
    """Consume ``chunk`` [C, H*interval] of live input, produce as many
    output samples.  Returns (state, out [C, H*interval])."""
    c, n = chunk.shape
    interval = config.interval
    h = n // interval
    assert h * interval == n, (n, interval)
    r = state.ring.shape[1]

    ring = jnp.concatenate([state.ring[:, n:], chunk.astype(jnp.float32)], axis=1)
    # hop h analyzes the frame ending h+1 intervals before the ring's end
    # minus ... : input is consumed in lockstep with output (rate 1).
    ends = r - n + (jnp.arange(h, dtype=jnp.int32) + 1) * interval
    engine, out = process_chunk(config, state.engine, ring, ends, params)
    return LiveState(engine=engine, ring=ring), out
