"""StretchNode: one stretch voice with the reference node's control surface.

Mirrors the main-thread API the reference exposes per engine (async RPC
proxies over the worklet — reference: app/SignalsmithStretch.mjs:603-744 and
:1035-1058): ``configure``, ``latency``, ``setUpdateInterval``, ``start``,
``stop``, ``schedule``, ``addBuffers``, ``dropBuffers``, plus the
``input_time`` property that the reference pushes as ``['time', t]``
messages (:938-942).

Execution model differs: instead of a real-time render-thread
callback, the node *pulls* output in arbitrary-size chunks
(:meth:`process_output`, the file-playback path) or *pushes* live input
(:meth:`process`).  Internally the engine runs one spectral hop per
``interval`` output samples via the jitted chunk function; an output FIFO
decouples hop granularity from caller chunk sizes (the reference's 128-frame
render quanta — app/SignalsmithStretch.mjs:820-826).

Single-voice convenience wrapper; fleets should use
``bauklank.serve.pool.StreamPool`` which batches many voices into one
dispatch.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.config import StretchConfig, preset_cheaper, preset_default
from bauklank.engine.core import init_state, process_chunk
from bauklank.engine.params import StretchParams
from bauklank.schedule.timemap import Segment, TimeMap

__all__ = ["StretchNode"]


@functools.partial(jax.jit, static_argnums=(0,))
def _chunk_jit(config, state, audio, packed):
    """packed [H+7] float32: hop frame-ends then the 7 StretchParams fields
    — one host->device transfer per dispatch (split small transfers each
    pay full transport latency on remote-attached devices)."""
    h = packed.shape[0] - 7
    ends = packed[:h].astype(jnp.int32)
    params = StretchParams(*[packed[h + i] for i in range(7)])
    return process_chunk(config, state, audio, ends, params)


@functools.partial(jax.jit, static_argnums=(0,))
def _fidelity_chunk_jit(scfg, state, audio, packed):
    """Fidelity-mode dispatch: same packed layout as :func:`_chunk_jit`;
    rate/transpose/tonality map onto the blob-exact core's controls
    (timeFactor = 1/rate, limit = tonality/sqrt(multiplier) — measured,
    docs/WASM-ALGO.md).  When ``scfg.formants`` is compiled in, the packed
    formant fields feed the blob's step 5."""
    from bauklank.engine.fidelity import fidelity_chunk

    h = packed.shape[0] - 7
    ends = packed[:h].astype(jnp.int32)
    params = StretchParams(*[packed[h + i] for i in range(7)])
    # the blob's seek clamps the effective timeFactor at `interval` when the
    # rate advances less than one input sample per hop (stored tf at 6156
    # measured == f32(min(1/rate, interval)); decoded round 5 by probing the
    # live blob across rate x geometry — boundary exactly tf > interval)
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
    return fidelity_chunk(
        scfg, state, audio, ends, tf, params.transpose_factor, limit,
        params.active, **kw,
    )


class StretchNode:
    """One stretch voice.

    audio model (file-playback mode): ``add_buffers`` appends channel
    buffers to a timeline, matching the reference worklet's buffer list +
    sample bookkeeping (app/SignalsmithStretch.mjs:737-743).
    """

    def __init__(
        self,
        sample_rate: float = 44100.0,
        channels: int = 2,
        config: StretchConfig | None = None,
        hops_per_dispatch: int = 1,
        engine: str = "fast",
    ) -> None:
        # hops_per_dispatch > 1 amortizes dispatch overhead for offline/bulk
        # rendering but pre-renders that many intervals ahead, delaying the
        # effect of schedule() changes; 1 keeps control latency at one
        # interval, closest to the reference's per-quantum control sampling
        # (app/SignalsmithStretch.mjs:845-849).
        #
        # engine: "fast" (the hop-parallel engine, engine.core) or
        # "fidelity" (the blob-exact reference algorithm, engine.spectral —
        # >=40 dB vs the actual reference renderer, tests/test_golden_wasm).
        # Fidelity mode covers the FULL control surface: stretch, pitch,
        # rate < 0.5 (the blob's MINSTD-random vertical steps replicated
        # draw-for-draw), and formant shift/compensation/base (the blob's
        # step 5, pinned via pymodel in tests/test_spectral.py).
        if engine not in ("fast", "fidelity"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.sample_rate = float(sample_rate)
        self.channels = channels
        self.config = config or preset_default(channels, sample_rate)
        if config is None:
            self._raw_sizes = (round(self.sample_rate * 0.12), round(self.sample_rate * 0.03))
        self.hops_per_dispatch = hops_per_dispatch
        self.timemap = TimeMap()
        self._buffers: list[np.ndarray] = []
        self._audio_dev: jnp.ndarray | None = None
        self._state = None
        self._out_pos = 0  # output samples rendered since reset
        self._fifo = np.zeros((channels, 0), np.float32)
        self.input_time = 0.0
        self._update_interval = 0.1
        self._update_cb: Callable[[float], None] | None = None
        self._since_update = 0.0
        self.reset()

    # ------------------------------------------------------------ engine ABI
    def configure(self, **kw) -> None:
        """Accepts the reference config keys: blockMs / intervalMs / overlap
        / splitComputation / preset (app/SignalsmithStretch.mjs:786-801).
        Reconfiguring resets the engine, like the reference (:791-792)."""
        if kw.get("preset") == "cheaper":
            self.config = preset_cheaper(self.channels, self.sample_rate)
            self._raw_sizes = (round(self.sample_rate * 0.1), round(self.sample_rate * 0.04))
        elif kw.get("preset") == "default":
            self.config = preset_default(self.channels, self.sample_rate)
            self._raw_sizes = (round(self.sample_rate * 0.12), round(self.sample_rate * 0.03))
        elif "blockMs" in kw or "block" in kw:
            block = int(kw.get("block") or round(kw["blockMs"] / 1000.0 * self.sample_rate))
            if "interval" in kw:
                interval = int(kw["interval"])
            elif "intervalMs" in kw:
                interval = round(kw["intervalMs"] / 1000.0 * self.sample_rate)
            elif "overlap" in kw:
                # the reference clamps overlap to [1, 8] before configuring
                # (app/multi/app.mjs:410); overlap < 1 would mean
                # interval > block, where the blob's Kaiser bandwidth law
                # has no real beta (engine.spectral.blob_window)
                interval = round(block / min(8.0, max(1.0, float(kw["overlap"]))))
            else:
                interval = round(block * 0.25)  # reference default (:787)
            if interval > block:
                raise ValueError(
                    f"interval ({interval}) must not exceed block ({block}): "
                    "gapped analysis has no COLA window (reference UI clamps "
                    "overlap to [1, 8], app/multi/app.mjs:410)")
            self._raw_sizes = (block, max(1, interval))
            self.config = StretchConfig(
                channels=self.channels,
                block=block,
                interval=max(1, interval),
                split_computation=bool(kw.get("splitComputation", self.config.split_computation)),
            )
        self.reset()

    @property
    def _scfg(self):
        """Fidelity-mode static config: the blob keeps the REQUESTED block
        (no fast-size rounding; its FFT zero-pads to 2^a*{1,3,5} above it —
        docs/WASM-ALGO.md 'Sizes'), so latency/windowing match exactly."""
        from bauklank.engine.fidelity import SpectralConfig

        block, interval = getattr(
            self, "_raw_sizes", (self.config.block, self.config.interval)
        )
        return SpectralConfig(self.channels, block, interval,
                              split=self.config.split_computation)

    def reset(self) -> None:
        if self.engine == "fidelity":
            from bauklank.engine.fidelity import init_fidelity_state

            self._state = init_fidelity_state(self._scfg)
        else:
            self._state = init_state(self.config)
        self._out_pos = 0
        self._fifo = np.zeros((self.channels, 0), np.float32)
        self._since_update = 0.0

    @property
    def block_samples(self) -> int:
        return self._scfg.block if self.engine == "fidelity" else self.config.block

    @property
    def interval_samples(self) -> int:
        return self._scfg.interval if self.engine == "fidelity" else self.config.interval

    @property
    def input_latency(self) -> int:
        return self.block_samples // 2 if self.engine == "fidelity" else self.config.input_latency

    @property
    def output_latency(self) -> int:
        if self.engine == "fidelity":
            # block/2 + interval with split on; split off drops the
            # +interval (reference README-signalsmith.md:26-31)
            b = self.block_samples
            extra = self.interval_samples if self.config.split_computation else 0
            return (b - b // 2) + extra
        return self.config.output_latency

    def latency(self) -> float:
        """Total latency in seconds (reference node method `latency`)."""
        return (self.input_latency + self.output_latency) / self.sample_rate

    def set_update_interval(self, seconds: float, callback=None) -> None:
        self._update_interval = float(seconds)
        self._update_cb = callback

    # ------------------------------------------------------------- schedule
    def schedule(self, obj: dict, adjust_previous: bool = False) -> Segment:
        return self.timemap.schedule(obj, adjust_previous)

    def start(self, when: float | None = None, offset: float = 0.0, duration=None,
              rate=None, semitones=None) -> None:
        when = self.output_time if when is None else when
        self.timemap.start(when, offset, duration, rate, semitones)

    def stop(self, when: float | None = None) -> None:
        self.timemap.stop(self.output_time if when is None else when)

    @property
    def output_time(self) -> float:
        """Current playhead in seconds, offset by output latency like the
        reference's ``currentTime + outputLatencySeconds`` (:840)."""
        return self._out_pos / self.sample_rate + self.output_latency / self.sample_rate

    # -------------------------------------------------------------- buffers
    def add_buffers(self, channel_arrays) -> int:
        """Append one multi-channel buffer; returns total samples loaded."""
        arrs = [np.asarray(a, np.float32) for a in channel_arrays]
        n = arrs[0].shape[0]
        data = np.stack([arrs[c % len(arrs)][:n] for c in range(self.channels)])
        self._buffers.append(data)
        self._audio_dev = None
        return sum(b.shape[1] for b in self._buffers)

    def drop_buffers(self) -> None:
        self._buffers = []
        self._audio_dev = None

    def _device_audio(self) -> jnp.ndarray:
        if self._audio_dev is None:
            if self._buffers:
                track = np.concatenate(self._buffers, axis=1)
            else:
                track = np.zeros((self.channels, 1), np.float32)
            self._audio_dev = jnp.asarray(track)
        return self._audio_dev

    # ------------------------------------------------------------ rendering
    def process_output(self, n_samples: int) -> np.ndarray:
        """File-playback pull: render the next ``n_samples`` of output.

        Equivalent to the reference hot path: advance the time map, derive
        the input read position per hop, seek + process
        (app/SignalsmithStretch.mjs:884-936).
        """
        while self._fifo.shape[1] < n_samples:
            deficit = n_samples - self._fifo.shape[1]
            hops_needed = -(-deficit // self.interval_samples)
            # bucket large pulls into big dispatches (compiled per bucket);
            # small pulls keep hops_per_dispatch-granularity control latency.
            # 256-hop buckets matter on remote-attached devices: a bulk
            # render is bounded by dispatch round trips, not device time
            hops = self.hops_per_dispatch
            for bucket in (1024, 256, 64, 16):
                if hops_needed >= bucket:
                    hops = bucket
                    break
            # a chunk shares one parameter set: never render across the next
            # schedule boundary (params are sampled per chunk, times per hop)
            hops = min(hops, max(1, self._hops_to_boundary()))
            self._render_hops(hops)
        out, self._fifo = self._fifo[:, :n_samples], self._fifo[:, n_samples:]
        self._out_pos += n_samples
        # report the playhead at the *pulled* position (the reference posts
        # ['time', inputTime] for the quantum it just rendered, :938-942)
        self.input_time = self.timemap.input_time_at(self.output_time)
        return out

    def _params_equal(self, a: Segment, b: Segment) -> bool:
        """True when two segments share every per-chunk parameter.

        Timing fields (output/input anchors, rate, loop points) are encoded
        per hop in the frame-end table, so a boundary that changes only
        timing does NOT force a dispatch split in the fast engine — a whole
        rate *schedule* rides one dispatch.  The fidelity engine consumes
        rate as a spectral parameter (timeFactor), so rate splits there."""
        same = (
            a.active == b.active
            and a.semitones == b.semitones
            and a.tonality_hz == b.tonality_hz
            and a.formant_semitones == b.formant_semitones
            and a.formant_compensation == b.formant_compensation
            and a.formant_base_hz == b.formant_base_hz
        )
        if self.engine == "fidelity":
            same = same and a.rate == b.rate
        return same

    def _hops_to_boundary(self) -> int:
        """Hops renderable before a segment with *different parameters*
        takes effect (rate-only boundaries render within one chunk)."""
        segs = self.timemap.segments
        next_out = None
        for k in range(1, len(segs)):
            if not self._params_equal(segs[k - 1], segs[k]):
                next_out = segs[k].output
                break
        if next_out is None:
            return 1 << 30
        sr = self.sample_rate
        next_out -= self.output_latency / sr
        rendered = self._out_pos + self._fifo.shape[1]
        # hop h samples its params at (rendered + h*I + B/2)/sr (+latency)
        samples_left = (next_out * sr) - rendered - self.block_samples / 2
        return int(np.floor(samples_left / self.interval_samples))

    def _render_hops(self, n_hops: int) -> None:
        fid = self.engine == "fidelity"
        block, interval = self.block_samples, self.interval_samples
        sr = self.sample_rate
        audio = self._device_audio()
        packed = np.zeros(n_hops + 7, np.float32)
        seg = None
        for h in range(n_hops):
            if fid:
                # worklet drive: inputTime sampled at the hop's output-
                # counter position (+ output latency); frame ends at
                # round(inputTime*sr) + inputLatency (docs/WASM-ALGO.md)
                out_s = self._out_pos + self._fifo.shape[1] + h * interval
            else:
                # fast engine: frame CENTER maps from the output frame center
                out_s = self._out_pos + self._fifo.shape[1] + h * interval + block // 2
            out_t = out_s / sr + self.output_latency / sr
            in_t = self.timemap.input_time_at(out_t)
            packed[h] = float(int(round(in_t * sr)) + block // 2)
            seg = self.timemap.current()
        packed[n_hops:] = (
            1.0 if seg.active else 0.0,
            seg.rate,
            2.0 ** (seg.semitones / 12.0),
            seg.tonality_hz / sr,
            2.0 ** (seg.formant_semitones / 12.0),
            1.0 if seg.formant_compensation else 0.0,
            seg.formant_base_hz / sr,
        )
        if fid:
            scfg = self._scfg
            if seg.formant_semitones != 0.0 or seg.formant_compensation:
                scfg = scfg._replace(formants=True)
            self._state, out = _fidelity_chunk_jit(
                scfg, self._state, audio, jnp.asarray(packed)
            )
        else:
            # host-side formant gating (see serve.pool.StreamPool.step)
            cfg = self.config
            if cfg.formants and not (
                seg.formant_semitones != 0.0 or seg.formant_compensation
            ):
                from bauklank.engine.batched import formants_off

                cfg = formants_off(cfg)
            self._state, out = _chunk_jit(cfg, self._state, audio, jnp.asarray(packed))
        self._fifo = np.concatenate([self._fifo, np.asarray(out)], axis=1)
        self._since_update += out.shape[1] / sr
        if self._update_cb and self._since_update >= self._update_interval:
            self._since_update = 0.0
            self._update_cb(self.input_time)

    # ------------------------------------------------------------- live mode
    def process(self, input_chunk) -> np.ndarray:
        """Live-input mode: feed a [C, n] (or [n]) chunk, get n stretched
        output samples (reference coupled path, _process(N, N) —
        app/SignalsmithStretch.mjs:870-882).  Output lags by about one block;
        arbitrary chunk sizes are FIFO-buffered around whole hops."""
        from bauklank.engine.live import init_live_state, process_live

        x = np.asarray(input_chunk, np.float32)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.channels, x.shape[0]))
        n = x.shape[1]
        if not hasattr(self, "_live"):
            self._live = init_live_state(self.config, 1)
            self._live_in = np.zeros((self.channels, 0), np.float32)
            self._live_out = np.zeros((self.channels, 0), np.float32)
        self._live_in = np.concatenate([self._live_in, x], axis=1)
        interval = self.config.interval
        seg = self.timemap.current()
        params = StretchParams.make(
            active=1.0,
            rate=1.0,
            semitones=seg.semitones,
            tonality_hz=seg.tonality_hz,
            formant_semitones=seg.formant_semitones,
            formant_compensation=1.0 if seg.formant_compensation else 0.0,
            formant_base_hz=seg.formant_base_hz,
            sample_rate=self.sample_rate,
        )
        while self._live_in.shape[1] >= interval:
            chunk, self._live_in = self._live_in[:, :interval], self._live_in[:, interval:]
            self._live, out = process_live(self.config, self._live, jnp.asarray(chunk), params)
            self._live_out = np.concatenate([self._live_out, np.asarray(out)], axis=1)
        if self._live_out.shape[1] >= n:
            out, self._live_out = self._live_out[:, :n], self._live_out[:, n:]
        else:  # warm-up: pad with leading zeros
            pad = n - self._live_out.shape[1]
            out = np.concatenate(
                [np.zeros((self.channels, pad), np.float32), self._live_out], axis=1
            )
            self._live_out = np.zeros((self.channels, 0), np.float32)
        return out

    def flush(self) -> np.ndarray:
        """Emit the remaining overlap-add tail (reference `_flush`)."""
        if self.engine == "fidelity":
            spec_state, tail = self._state
            self._state = (spec_state, jnp.zeros_like(tail))
            return np.asarray(tail)
        from bauklank.engine.core import flush as engine_flush

        self._state, tail = engine_flush(self.config, self._state)
        return np.asarray(tail)
