"""StreamPool: many voices, one batched device dispatch per step.

This is the batched replacement for the reference's per-engine
AudioWorklet instances + Web Audio mixing graph (gain -> panL/panR ->
ChannelMerger(2) -> destination — reference: app/multi/app.mjs:149-162,
340-351).  All voices share one engine configuration (shape), one device
step, and one mixdown; per-voice rate/pitch/formant state is data
(BASELINE config 5: 64+ independent streams).

Control semantics mirror ``applyIncomingSet`` / ``controlsChanged``
(app/multi/app.mjs:537-616, 434-534): control keys route into each voice's
time map with a configurable look-ahead (0.1 s in the reference, :494);
volume/pan ramp linearly over 30 ms (:450-465); clamps follow §2.5
(rate [1e-5, 2], semitones ±48, tonalityHz [20, 22050],
formantBaseHz [20, 2000]).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.batched import batched_process_chunk, init_batched_state
from bauklank.engine.config import StretchConfig, preset_default
from bauklank.engine.params import StretchParams
from bauklank.schedule.timemap import TimeMap

__all__ = ["StreamPool", "VoiceSlot", "CONTROL_CLAMPS"]

SCHEDULE_LOOKAHEAD_SEC = 0.1  # reference: app/multi/app.mjs:494
RAMP_SEC = 0.03               # reference: app/multi/app.mjs:454

CONTROL_CLAMPS = {
    "rate": (1e-5, 2.0),          # app/multi/app.mjs:483
    "semitones": (-48.0, 48.0),   # :484
    "tonalityHz": (20.0, 22050.0),
    "formantSemitones": (-48.0, 48.0),
    "formantBaseHz": (0.0, 2000.0),  # 0 = auto-detect stays allowed
}

_TIMEMAP_KEYS = {
    "active", "rate", "semitones", "tone", "tonalityHz", "formantSemitones",
    "formantCompensation", "formantBaseHz", "loopStart", "loopEnd",
    # playback-slider seek: the reference drag handler schedules {input: v}
    # (app/multi/app.mjs:735-737)
    "input",
}

# keys whose values must be finite numbers (everything except the booleans)
_NUMERIC_KEYS = (_TIMEMAP_KEYS | {"volume", "volumePercent", "pan"}) - {
    "active", "formantCompensation",
}


@dataclasses.dataclass
class VoiceSlot:
    name: str
    timemap: TimeMap = dataclasses.field(default_factory=TimeMap)
    volume: float = 0.1      # kiosk default (app/multi/app.mjs:106-130)
    pan: float = 0.0
    _prev_volume: float = 0.1
    _prev_pan: float = 0.0
    track_len: int = 0
    loaded: bool = False


def _mixdown(out, gains, pans):
    """30ms-style linear mix ramp + stereo mixdown (reference graph
    gain -> panL/panR -> ChannelMerger, app/multi/app.mjs:149-162)."""
    n = out.shape[-1]
    t = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)[None, :]
    g = gains[:, :1] + (gains[:, 1:] - gains[:, :1]) * t      # [S, n]
    p = pans[:, :1] + (pans[:, 1:] - pans[:, :1]) * t          # [S, n]
    mono = jnp.mean(out, axis=1)                               # [S, n]
    pan_l = jnp.minimum(1.0, 1.0 - p)
    pan_r = jnp.minimum(1.0, 1.0 + p)
    master_l = jnp.sum(mono * g * pan_l, axis=0)
    master_r = jnp.sum(mono * g * pan_r, axis=0)
    return jnp.stack([master_l, master_r])


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _pool_step(config, states, audios, packed):
    """One batched step + mix ramp + stereo mixdown.

    ``packed`` [S, H + 11] float32 carries per-stream hop tables, params,
    and mix ramps in ONE host->device transfer (split transfers each pay
    the full transport latency on remote-attached devices):
      [:H] frame ends, [H:H+7] StretchParams fields, [H+7:H+9] gain
      (start, end), [H+9:H+11] pan (start, end).
    Returns (states, master [2, n], streams [S, C, n]).
    """
    h = packed.shape[1] - 11
    ends = packed[:, :h].astype(jnp.int32)
    params = StretchParams(*[packed[:, h + i] for i in range(7)])
    states, out = batched_process_chunk(config, states, audios, ends, params)
    return states, _mixdown(out, packed[:, h + 7 : h + 9], packed[:, h + 9 : h + 11]), out


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _pool_step_fidelity(scfg, states, audios, packed):
    """Fidelity-mode pool step: same packed layout as :func:`_pool_step`,
    dispatching the blob-exact core (engine.spectral) — the band scan runs
    once, vectorized across all streams.  With
    ``scfg.formants`` compiled in, the packed formant fields drive the
    blob's step 5 per stream."""
    from bauklank.engine.fidelity import batched_fidelity_chunk

    h = packed.shape[1] - 11
    ends = packed[:, :h].astype(jnp.int32)
    params = StretchParams(*[packed[:, h + i] for i in range(7)])
    # blob seek law: effective timeFactor saturates at `interval` when the
    # rate advances < 1 input sample per hop (see node._fidelity_chunk_jit)
    tf = jnp.minimum(1.0 / jnp.maximum(params.rate, 1e-6),
                     jnp.float32(scfg.interval))
    limit = params.tonality / jnp.sqrt(params.transpose_factor)
    kw = {}
    if scfg.formants:
        kw = dict(
            formant_factor=params.formant_factor,
            formant_compensation=params.formant_compensation,
            formant_base=params.formant_base,
        )
    states, out = batched_fidelity_chunk(
        scfg, states, audios, ends, tf, params.transpose_factor, limit,
        params.active, **kw,
    )
    return states, _mixdown(out, packed[:, h + 7 : h + 9], packed[:, h + 9 : h + 11]), out


class StreamPool:
    """Fixed-capacity batched voice pool.

    capacity is a compile-time shape; slots are named (defaults "s00"...,
    or the kiosk's "A"/"B" naming if you pass names).
    """

    def __init__(
        self,
        capacity: int = 64,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        max_track_sec: float = 30.0,
        names: list[str] | None = None,
        hops_per_step: int = 1,
        engine: str = "fast",
        max_rate: float = 2.0,
    ) -> None:
        # engine: "fast" (hop-parallel, engine.core) or
        # "fidelity" (blob-exact reference algorithm, engine.spectral).
        # See StretchNode.__init__ for the mode semantics and current
        # fidelity-mode limitations (formants, rates outside [0.5, 2]).
        if engine not in ("fast", "fidelity"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        # per-pool clamp table: the multi app clamps rate to [1e-5, 2]
        # (app/multi/app.mjs:483) while the single/dev app allows up to 4
        # (app/app.mjs:538) — dev-preset pools pass max_rate=4.0
        self.clamps = dict(CONTROL_CLAMPS)
        self.clamps["rate"] = (CONTROL_CLAMPS["rate"][0], float(max_rate))
        self.sample_rate = float(sample_rate)
        self.config = config or preset_default(channels, sample_rate)
        if engine == "fidelity":
            from bauklank.engine.fidelity import SpectralConfig

            block = (round(sample_rate * 0.12) if config is None else config.block)
            interval = (round(sample_rate * 0.03) if config is None else config.interval)
            self.scfg = SpectralConfig(channels, block, interval,
                                       split=self.config.split_computation)
        self.capacity = capacity
        self.hops_per_step = hops_per_step
        self.max_track = int(max_track_sec * sample_rate)
        # frame-end sample indices ride the packed float32 h2d array; float32
        # is integer-exact only below 2**24 (~380 s at 44.1 kHz)
        if self.max_track + self.config.block >= 2**24:
            raise ValueError(
                f"max_track_sec={max_track_sec} exceeds float32-exact frame "
                f"positioning (track + block must stay < 2**24 samples)"
            )
        self.slots = [VoiceSlot(names[i] if names else f"s{i:02d}") for i in range(capacity)]
        self._by_name = {s.name: i for i, s in enumerate(self.slots)}
        self._audio_host = np.zeros((capacity, channels, self.max_track), np.float32)
        self._audio_dev: jnp.ndarray | None = None
        if engine == "fidelity":
            from bauklank.engine.fidelity import init_batched_fidelity_state

            self.states = init_batched_fidelity_state(self.scfg, capacity)
        else:
            self.states = init_batched_state(self.config, capacity)
        self.out_pos = 0  # output samples stepped so far
        from collections import deque

        # in-flight masters for the pipelined fetch mode (step(fetch="pipeline"))
        self.pipeline_depth = 2
        self._fetch_q: deque = deque()
        from bauklank.utils.metrics import StepTimer

        self.timer = StepTimer(sample_rate)

    # ------------------------------------------------------------- loading
    def load_track(self, slot: str, channel_arrays) -> int:
        i = self._by_name[slot]
        arrs = [np.asarray(a, np.float32) for a in channel_arrays]
        n = min(arrs[0].shape[0], self.max_track)
        c = self._audio_host.shape[1]
        self._audio_host[i] = 0.0
        for ch in range(c):
            self._audio_host[i, ch, :n] = arrs[ch % len(arrs)][:n]
        self.slots[i].track_len = n
        self.slots[i].loaded = True
        self._audio_dev = None
        return n

    def drop_track(self, slot: str) -> None:
        i = self._by_name[slot]
        self._audio_host[i] = 0.0
        self.slots[i].track_len = 0
        self.slots[i].loaded = False
        self._audio_dev = None

    # -------------------------------------------------- slot lifecycle
    def _init_one_state(self):
        if self.engine == "fidelity":
            from bauklank.engine.fidelity import init_batched_fidelity_state

            return init_batched_fidelity_state(self.scfg, 1)
        return init_batched_state(self.config, 1)

    def clear_voice(self, slot: str) -> None:
        """Fully reset one voice (engine state, audio, time map, mix) so its
        batch row can be reused — the reference resets the whole engine on
        reconfigure (app/SignalsmithStretch.mjs:791-792); here only the one
        row resets."""
        i = self._by_name[slot]
        self._audio_host[i] = 0.0
        self._audio_dev = None
        self.slots[i] = VoiceSlot(slot)
        one = self._init_one_state()
        self.states = jax.tree.map(lambda a, o: a.at[i].set(o[0]), self.states, one)

    def grow(self, new_capacity: int) -> None:
        """Extend capacity in place, preserving every existing voice's state
        bit-exactly (config-bucket growth in the unified pool).  Changes the
        batch shape, so the next step recompiles."""
        if new_capacity <= self.capacity:
            return
        pad = new_capacity - self.capacity
        c, t = self._audio_host.shape[1:]
        self._audio_host = np.concatenate(
            [self._audio_host, np.zeros((pad, c, t), np.float32)]
        )
        self._audio_dev = None
        taken = set(self._by_name)
        k = self.capacity
        while len(self.slots) < new_capacity:
            name = f"s{k:02d}"
            k += 1
            if name not in taken:
                self.slots.append(VoiceSlot(name))
        self._by_name = {s.name: i for i, s in enumerate(self.slots)}
        if self.engine == "fidelity":
            from bauklank.engine.fidelity import init_batched_fidelity_state

            extra = init_batched_fidelity_state(self.scfg, pad)
        else:
            extra = init_batched_state(self.config, pad)
        self.states = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self.states, extra
        )
        self.capacity = new_capacity

    def _device_audio(self) -> jnp.ndarray:
        if self._audio_dev is None:
            self._audio_dev = jnp.asarray(self._audio_host)
        return self._audio_dev

    # ------------------------------------------------------------- control
    @property
    def _sizes(self):
        """(block, interval, output_latency) for the active engine mode."""
        if self.engine == "fidelity":
            b, i = self.scfg.block, self.scfg.interval
            return b, i, (b - b // 2) + (i if self.scfg.split else 0)
        c = self.config
        return c.block, c.interval, c.output_latency

    @property
    def output_time(self) -> float:
        return self.out_pos / self.sample_rate + self._sizes[2] / self.sample_rate

    def apply_set(self, slot: str, key: str, value: Any, lookahead: float = SCHEDULE_LOOKAHEAD_SEC) -> bool:
        """Route one control change (the §2.3 ``set`` message) to a voice.

        Returns False for unknown slots/keys or malformed values (logged by
        the server layer).  Values arrive from unauthenticated WS/serial
        JSON, where NaN/Infinity tokens and nulls are representable — one
        NaN rate would permanently poison the time map and crash-loop every
        subsequent pool step, so non-finite and non-numeric values are
        rejected here rather than clamped.
        """
        if slot not in self._by_name:
            return False
        i = self._by_name[slot]
        s = self.slots[i]
        if key in _NUMERIC_KEYS:
            try:
                value = float(value)
            except (TypeError, ValueError):
                return False
            if not math.isfinite(value):
                return False
        if key in ("volume", "volumePercent"):
            v = value / (100.0 if key == "volumePercent" else 1.0)
            s.volume = float(np.clip(v, 0.0, 1.0))
            return True
        if key == "pan":
            s.pan = float(np.clip(value, -1.0, 1.0))
            return True
        if key not in _TIMEMAP_KEYS:
            return False
        if key == "input" and s.track_len > 0:
            # the reference slider handler clamps the seek to
            # [0, audioDuration] (app/multi/app.mjs:736); un-clamped WS
            # seeks would schedule out-of-range frame ends.  Only when a
            # track is loaded: trackless slots (tests, live voices) keep
            # the raw value — there is no duration to clamp against.
            value = float(np.clip(value, 0.0, s.track_len / self.sample_rate))
        if key in self.clamps or (key == "tone"):
            lo, hi = self.clamps.get("semitones" if key == "tone" else key, (None, None))
            if lo is not None:
                value = float(np.clip(value, lo, hi))
        s.timemap.schedule({key: value, "output": self.output_time + lookahead})
        return True

    def schedule(self, slot: str, obj: dict, adjust_previous: bool = False):
        return self.slots[self._by_name[slot]].timemap.schedule(obj, adjust_previous)

    def start(self, slot: str, when: float | None = None, **kw) -> None:
        self.slots[self._by_name[slot]].timemap.start(
            self.output_time if when is None else when, **kw
        )

    def stop(self, slot: str, when: float | None = None) -> None:
        self.slots[self._by_name[slot]].timemap.stop(
            self.output_time if when is None else when
        )

    def input_time(self, slot: str) -> float:
        return self.slots[self._by_name[slot]].timemap.input_time_at(self.output_time)

    def is_playing(self, slot: str) -> bool:
        """True when the voice is in active file playback — the branch in
        which the reference worklet posts ``['time', inputTime]``
        (app/SignalsmithStretch.mjs:884-942)."""
        if slot not in self._by_name:
            return False
        s = self.slots[self._by_name[slot]]
        return s.loaded and bool(s.timemap.current().active)

    # --------------------------------------------------------------- step
    def step(self, fetch: bool | str = False):
        """Render the next chunk for every voice.

        Returns (master [2, n], streams [S, C, n]); n = hops_per_step *
        interval.  With ``fetch=True`` the master mix is materialized to
        numpy (fencing the device work — honest latency accounting for the
        serving loop; see utils.metrics).

        ``fetch="pipeline"`` double-buffers the device->host transfer: the
        current master's copy is *started* asynchronously and the master
        from ``pipeline_depth`` steps ago is returned (None while the
        pipeline fills).  On remote-attached devices the transfer round
        trip — not the 2-3 ms device step — dominates blocking-fetch
        latency; giving each transfer
        ``depth`` steps of lead time hides it, at the cost of
        depth * hops_per_step * interval samples of extra output latency.
        The reference's real-time contract is the analogous one-quantum
        pipeline of the audio render thread (app/SignalsmithStretch.mjs:
        820-826: each process() call produces the quantum the DAC plays
        next, never the one currently sounding).
        """
        self.timer.start()
        sr = self.sample_rate
        h = self.hops_per_step
        block, interval, out_lat = self._sizes
        fid = self.engine == "fidelity"
        # single packed host->device transfer per step (see _pool_step)
        packed = np.zeros((self.capacity, h + 11), np.float32)
        for i, s in enumerate(self.slots):
            seg = None
            for k in range(h):
                # fidelity: worklet drive samples inputTime at the hop's
                # output-counter position; fast engine: at the frame center
                out_s = self.out_pos + k * interval + (0 if fid else block // 2)
                out_t = out_s / sr + out_lat / sr
                in_t = s.timemap.input_time_at(out_t)
                packed[i, k] = float(int(round(in_t * sr)) + block // 2)
                seg = s.timemap.current()
            packed[i, h : h + 7] = (
                1.0 if (seg.active and s.loaded) else 0.0,
                seg.rate,
                2.0 ** (seg.semitones / 12.0),
                seg.tonality_hz / sr,
                2.0 ** (seg.formant_semitones / 12.0),
                1.0 if seg.formant_compensation else 0.0,
                seg.formant_base_hz / sr,
            )
            packed[i, h + 7 : h + 9] = (s._prev_volume, s.volume)
            packed[i, h + 9 : h + 11] = (s._prev_pan, s.pan)
            s._prev_volume = s.volume
            s._prev_pan = s.pan
        if fid:
            scfg = self.scfg
            if np.any(packed[:, h + 4] != 1.0) or np.any(packed[:, h + 5] != 0.0):
                scfg = scfg._replace(formants=True)
            self.states, master, streams = _pool_step_fidelity(
                scfg, self.states, self._device_audio(), jnp.asarray(packed)
            )
        else:
            # host-side formant gating: when NO voice uses formant controls
            # this step, dispatch the formants-off compile of the same step
            # (same state pytree; the reference engine gates identically —
            # docs/WASM-ALGO.md step 5).  Saves three envelope-FFT passes
            # per hop for the (typical) formant-neutral pool.
            cfg = self.config
            if cfg.formants and not (
                np.any(packed[:, h + 4] != 1.0) or np.any(packed[:, h + 5] != 0.0)
            ):
                from bauklank.engine.batched import formants_off

                cfg = formants_off(cfg)
            self.states, master, streams = _pool_step(
                cfg, self.states, self._device_audio(), jnp.asarray(packed)
            )
        self.out_pos += h * interval
        self._last_streams = streams  # device-resident; analyzed on demand
        if fetch == "pipeline":
            master.copy_to_host_async()
            self._fetch_q.append(master)
            master = (
                np.asarray(self._fetch_q.popleft())
                if len(self._fetch_q) > self.pipeline_depth
                else None
            )
        elif fetch:
            master = np.asarray(master)
        self.timer.tick(self.capacity * h * interval)
        return master, streams

    def drain(self) -> list[np.ndarray]:
        """Materialize any masters still in the fetch pipeline (call after
        the last ``step(fetch="pipeline")`` so no rendered audio is lost)."""
        out = [np.asarray(m) for m in self._fetch_q]
        self._fetch_q.clear()
        return out

    # ------------------------------------------------------------- analyze
    def analyze(self, slot: str, n_buckets: int = 128) -> dict | None:
        """Scope/spectrum/levels of a voice's last rendered chunk — the
        servable form of the reference's (disabled) Scope visualizer
        (app/Scope.mjs:362-428; meters piped via postMessage :398-428).
        Computed on device from the retained chunk; one d2h per request."""
        if slot not in self._by_name or getattr(self, "_last_streams", None) is None:
            return None
        from bauklank.ops import analyze as analyze_ops

        i = self._by_name[slot]
        sig = self._last_streams[i]              # [C, n] device
        mono = jnp.mean(sig, axis=0)
        n = int(mono.shape[-1])
        n_fft = 1 << max(4, (n.bit_length() - 1))
        n_fft = min(n_fft, 2048)
        scope = np.asarray(analyze_ops.scope_buckets(mono, min(n_buckets, n)))
        spectrum = np.asarray(analyze_ops.spectrum_db(mono, n_fft=n_fft))
        lv = analyze_ops.levels(sig)
        return {
            "slot": slot,
            "scope": [[round(float(a), 5), round(float(b), 5)] for a, b in scope],
            "spectrum": [round(float(v), 1) for v in spectrum],
            "spectrumHzPerBin": self.sample_rate / n_fft,
            "levels": {
                "rms": [round(float(v), 6) for v in np.asarray(lv["rms"])],
                "peak": [round(float(v), 6) for v in np.asarray(lv["peak"])],
            },
        }

    def metrics(self) -> dict:
        """Rolling serving metrics: step p50/p99 latency + aggregate RTF."""
        return self.timer.snapshot()
