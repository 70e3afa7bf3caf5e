"""LivePool: batched live-input processing for many streams.

The reference supports live input per engine — copy each render quantum into
the input planes and process coupled (app/SignalsmithStretch.mjs:870-882) —
but one WASM instance per voice caps it at a couple of streams.  Here N live
streams (e.g. one per connected client) share one batched device step: each
stream owns a host-side input FIFO; every step consumes exactly one interval
per stream (zero-filled on underrun, like the reference's silent-input
branch :861-869) and produces one interval of pitch/formant-processed
output per stream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.config import StretchConfig
from bauklank.engine.live import LiveState, init_live_state, process_live
from bauklank.engine.params import StretchParams
from bauklank.schedule.timemap import TimeMap

__all__ = ["LivePool"]


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _live_step(config, states, chunks, packed):
    # packed [S, 7]: StretchParams fields in one host->device transfer
    params = StretchParams(*[packed[:, i] for i in range(7)])
    fn = functools.partial(process_live, config)
    return jax.vmap(fn)(states, chunks, params)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _live_fidelity_step(scfg, states, chunks, packed):
    """Blob-exact coupled step: the live analog of
    serve.pool._pool_step_fidelity.  Rate does not apply (the reference live
    branch consumes input in lockstep with output and never seeks —
    app/SignalsmithStretch.mjs:870-882); transpose/tonality/formant params
    map onto the blob controls exactly as in file mode."""
    from bauklank.engine.fidelity import batched_live_fidelity_chunk

    params = StretchParams(*[packed[:, i] for i in range(7)])
    mult = params.transpose_factor
    limit = params.tonality / jnp.sqrt(mult)
    kw = {}
    if scfg.formants:
        kw = dict(
            formant_factor=params.formant_factor,
            formant_compensation=params.formant_compensation,
            formant_base=params.formant_base,
        )
    return batched_live_fidelity_chunk(
        scfg, states, chunks, mult, limit, params.active, **kw
    )


class LivePool:
    """N live voices, one dispatch per interval."""

    def __init__(
        self,
        capacity: int = 16,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        names: list[str] | None = None,
        hops_per_step: int = 1,
        engine: str = "fast",
    ) -> None:
        # hops_per_step > 1 amortizes dispatch latency (valuable on
        # high-latency device attachments) at the cost of that many
        # intervals of extra control latency.
        # engine: "fast" (engine.core coupled ring) or "fidelity" (the
        # blob-exact coupled mode — same reference semantics as
        # StreamPool(engine="fidelity"), golden-gated vs coupled-mode blob
        # renders in tests/test_golden_wasm.py).
        from bauklank.engine.config import preset_default

        if engine not in ("fast", "fidelity"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.sample_rate = float(sample_rate)
        self.config = config or preset_default(channels, sample_rate)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.names = names or [f"l{i:02d}" for i in range(capacity)]
        self._by_name = {n: i for i, n in enumerate(self.names)}
        if engine == "fidelity":
            from bauklank.engine.fidelity import (
                SpectralConfig, init_batched_live_fidelity_state,
            )

            self.scfg = SpectralConfig(
                channels, self.config.block, self.config.interval,
                split=self.config.split_computation,
            )
            self.states = init_batched_live_fidelity_state(
                self.scfg, hops_per_step, capacity
            )
        else:
            one = init_live_state(self.config, hops_per_step)
            self.states: LiveState = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (capacity,) + x.shape), one
            )
        self.timemaps = [TimeMap() for _ in range(capacity)]
        c = self.config.channels
        self._in_fifo = [np.zeros((c, 0), np.float32) for _ in range(capacity)]
        self.out_pos = 0
        from bauklank.utils.metrics import StepTimer

        self.timer = StepTimer(sample_rate)

    # -------------------------------------------------- slot lifecycle
    def _init_batched(self, n: int):
        """Fresh engine state for ``n`` streams (engine-mode aware)."""
        if self.engine == "fidelity":
            from bauklank.engine.fidelity import (
                init_batched_live_fidelity_state,
            )

            return init_batched_live_fidelity_state(
                self.scfg, self.hops_per_step, n
            )
        one = init_live_state(self.config, self.hops_per_step)
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n,) + x.shape), one
        )

    def clear_voice(self, slot: str) -> None:
        """Reset one live voice (engine state, input FIFO, time map) so the
        batch row can be reused (reference reset-on-configure semantics,
        app/SignalsmithStretch.mjs:791-792)."""
        i = self._by_name[slot]
        one = self._init_batched(1)
        self.states = jax.tree.map(lambda a, o: a.at[i].set(o[0]), self.states, one)
        self.timemaps[i] = TimeMap()
        self._in_fifo[i] = np.zeros((self.config.channels, 0), np.float32)

    def grow(self, new_capacity: int) -> None:
        """Extend capacity in place, preserving existing voices bit-exactly
        (config-bucket growth in the unified pool); next step recompiles."""
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        extra = self._init_batched(pad)
        self.states = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self.states, extra
        )
        taken = set(self._by_name)
        k = self.capacity
        while len(self.names) < new_capacity:
            name = f"l{k:02d}"
            k += 1
            if name not in taken:
                self.names.append(name)
        self._by_name = {n: i for i, n in enumerate(self.names)}
        c = self.config.channels
        self.timemaps.extend(TimeMap() for _ in range(pad))
        self._in_fifo.extend(np.zeros((c, 0), np.float32) for _ in range(pad))
        self.capacity = new_capacity

    def feed(self, slot: str, chunk) -> None:
        """Queue live input samples for one stream ([C, n] or [n])."""
        i = self._by_name[slot]
        x = np.asarray(chunk, np.float32)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.config.channels, x.shape[0]))
        self._in_fifo[i] = np.concatenate([self._in_fifo[i], x], axis=1)

    def schedule(self, slot: str, obj: dict) -> None:
        self.timemaps[self._by_name[slot]].schedule(obj)

    def apply_set(self, slot: str, key: str, value, lookahead: float = 0.1) -> bool:
        """Control routing compatible with StreamPool.apply_set (the server's
        ``set`` path); live voices have no rate/volume/pan (input-coupled,
        raw per-stream output) — those keys are acknowledged but ignored."""
        if slot not in self._by_name:
            return False
        if key in ("rate", "volume", "volumePercent", "pan"):
            return True
        from bauklank.serve.pool import CONTROL_CLAMPS, _TIMEMAP_KEYS

        if key not in _TIMEMAP_KEYS:
            return False
        lo, hi = CONTROL_CLAMPS.get("semitones" if key == "tone" else key, (None, None))
        if lo is not None:
            value = float(np.clip(float(value), lo, hi))
        out_t = self.out_pos / self.sample_rate + self.config.output_latency / self.sample_rate
        self.timemaps[self._by_name[slot]].schedule({key: value, "output": out_t + lookahead})
        return True

    def metrics(self) -> dict:
        return self.timer.snapshot()

    def step(self) -> np.ndarray:
        """Process hops_per_step intervals for every stream
        -> [S, C, hops_per_step * interval]."""
        cfg = self.config
        self.timer.start()
        n = cfg.interval * self.hops_per_step
        c = cfg.channels
        chunks = np.zeros((self.capacity, c, n), np.float32)
        for i in range(self.capacity):
            take = min(n, self._in_fifo[i].shape[1])
            chunks[i, :, :take] = self._in_fifo[i][:, :take]  # underrun -> zeros
            self._in_fifo[i] = self._in_fifo[i][:, take:]
        out_t = self.out_pos / self.sample_rate + cfg.output_latency / self.sample_rate
        sr = self.sample_rate
        packed = np.zeros((self.capacity, 7), np.float32)
        for i, tm in enumerate(self.timemaps):
            tm.advance_to(out_t)
            seg = tm.current()
            packed[i] = (
                1.0 if seg.active else 0.0,
                1.0,  # live mode consumes input in lockstep
                2.0 ** (seg.semitones / 12.0),
                seg.tonality_hz / sr,
                2.0 ** (seg.formant_semitones / 12.0),
                1.0 if seg.formant_compensation else 0.0,
                seg.formant_base_hz / sr,
            )
        if self.engine == "fidelity":
            # host-side formant gating, as in StreamPool.step: compile the
            # formant chain in only when some voice drives it this step
            scfg = self.scfg
            if np.any(packed[:, 4] != 1.0) or np.any(packed[:, 5] != 0.0):
                scfg = scfg._replace(formants=True)
            self.states, out = _live_fidelity_step(
                scfg, self.states, jnp.asarray(chunks), jnp.asarray(packed)
            )
        else:
            self.states, out = _live_step(
                self.config, self.states, jnp.asarray(chunks), jnp.asarray(packed)
            )
        self.out_pos += n
        result = np.asarray(out)
        self.timer.tick(self.capacity * n)
        return result
