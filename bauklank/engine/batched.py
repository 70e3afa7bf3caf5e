"""Batched multi-stream engine: many independent stretch voices per chip.

The reference runs at most two engines, each a separate AudioWorklet + WASM
instance mixed in the Web Audio graph (reference: app/multi/app.mjs:102-195,
349-351).  The batched equivalent is *stream parallelism*: one engine
state pytree with a leading stream axis, one jitted step for all streams
(BASELINE config 5: 64+ independent streams with per-stream rate/pitch
state).  Per-stream heterogeneity (rate, pitch, formants, activity) is pure
data; per-stream *shape* config (block/interval) stays static — streams that
need a different block size belong to a different engine pool, mirroring the
reference's engine reset on reconfigure (app/SignalsmithStretch.mjs:791-792).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bauklank.engine.config import StretchConfig
from bauklank.engine.core import StretchState, init_state, process_chunk
from bauklank.engine.params import StretchParams

__all__ = ["init_batched_state", "batched_process_chunk", "batched_step_jit"]


@functools.partial(jax.jit, static_argnums=(0, 1))
def init_batched_state(config: StretchConfig, n_streams: int) -> StretchState:
    # jitted so complex state materializes on-device (no complex h2d).
    one = init_state(config)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape), one)


def batched_process_chunk(
    config: StretchConfig,
    states: StretchState,
    audios: jnp.ndarray,
    frame_ends: jnp.ndarray,
    params: StretchParams,
):
    """vmapped :func:`process_chunk` over a leading stream axis.

    states:     StretchState with leading [S] axis
    audios:     [S, C, T] per-stream source audio (use a broadcasted track
                for shared content)
    frame_ends: [S, H] per-stream hop positions
    params:     StretchParams with leading [S] axis
    returns (states, out [S, C, H*interval])

    Callers that know host-side that no stream uses formant controls this
    dispatch should pass ``formants_off(config)`` instead of ``config`` —
    the formant-envelope chain is three extra FFT passes over every hop,
    and the reference engine likewise runs it only "when formantFactor !=
    1, or compensation and mapping" (docs/WASM-ALGO.md step 5).  The
    selection is a host-side static-config switch (two jit cache entries
    over the same state pytree), NOT a lax.cond: a cond would double the
    compiled graph, and under vmap it lowers to select and executes both
    branches anyway.
    """
    fn = functools.partial(process_chunk, config)
    return jax.vmap(fn)(states, audios, frame_ends, params)


def formants_off(config: StretchConfig) -> StretchConfig:
    """The same engine shape with the formant chain compiled out (state
    pytrees are identical, so states flow between the two step variants)."""
    import dataclasses

    return dataclasses.replace(config, formants=False)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def batched_step_jit(config, states, audios, frame_ends, params):
    """Jitted serving step with donated state (no HBM churn between steps)."""
    return batched_process_chunk(config, states, audios, frame_ends, params)
