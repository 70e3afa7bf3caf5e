"""Fidelity renderer: the reference worklet drive around the blob-exact core.

Reproduces ``native.render_reference`` (the reference worklet hot loop,
app/SignalsmithStretch.mjs:826-954, splitComputation on) as a batched
pipeline:

- host: per-hop input frame ends, replicating the worklet's float time
  accumulation bit-for-bit (the round() of inputTime*sr decides which
  sample each analysis window ends on — docs/WASM-ALGO.md "Worklet-drive");
- device, one jitted graph: batched windowed frame gather -> batched MDFT
  analyses for ALL hops -> ``lax.scan`` of the spectral core over hops
  (the only sequential part; its inner band scan vectorizes across
  batch/channels) -> batched inverse MDFT -> one overlap-add, frames placed
  at ``(h+1)*interval`` (the measured split-on placement).

The reference engine's output at rate 1 / factor 1 is an exact passthrough
with ``block`` samples latency; against the actual blob this renderer
measures 54-108 dB SNR over 2 s across rate {0.5,1,2} x semitones
{-12,0,+12} on tonal material (tests/test_golden_wasm.py), bounded only by
the renderer's own chaotic sensitivity (docs/WASM-ALGO.md "Sensitivity").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.spectral import (
    SpectralConfig,
    SpectralState,
    blob_window,
    init_spectral_state,
    spectral_hop,
)
from bauklank.ops import framing, mdft

__all__ = [
    "SpectralConfig",
    "FidelityState",
    "hop_frame_ends",
    "render_fidelity",
    "init_fidelity_state",
    "init_batched_fidelity_state",
    "fidelity_chunk",
    "batched_fidelity_chunk",
    "live_fidelity_ring_len",
    "init_batched_live_fidelity_state",
    "batched_live_fidelity_chunk",
]

QUANTUM = 128  # browser render quantum (reference :820-826)


def hop_frame_ends(
    cfg: SpectralConfig,
    n_hops: int,
    rate: float,
    sample_rate: float,
    input_offset: float = 0.0,
    split: bool = True,
) -> np.ndarray:
    """Per-hop analysis frame ends (exclusive, in track samples).

    Hop ``h`` fires at output-counter sample ``o = h*interval``; its
    analyses see the ring primed by the seek of the quantum containing
    ``o``: inputEnd = round((seg.input + (q*128/sr + outLat_sec)*rate +
    inLat_sec) * sr), with the quantum clock ACCUMULATED in float64 exactly
    like the worklet restatement (native.py:241-284) — the rounding at
    half-sample boundaries depends on it.

    ``split``: splitComputation mode; it changes outputLatency (split off
    drops the +interval — reference README-signalsmith.md:26-31) and hence
    every inputEnd.
    """
    sr = float(sample_rate)
    in_lat = cfg.block // 2
    out_lat = (cfg.block - cfg.block // 2) + (cfg.interval if split else 0)
    in_lat_sec, out_lat_sec = in_lat / sr, out_lat / sr
    n_q = (n_hops * cfg.interval) // QUANTUM + 1
    ie_by_q = np.empty(n_q, np.int64)
    t = 0.0
    for q in range(n_q):
        ie_by_q[q] = round((input_offset + (t + out_lat_sec) * rate + in_lat_sec) * sr)
        t += QUANTUM / sr
    hops = np.arange(n_hops)
    return ie_by_q[(hops * cfg.interval) // QUANTUM].astype(np.int32)


@functools.lru_cache(maxsize=64)
def _consts(block: int, interval: int, fft: int):
    w = blob_window(block, interval).astype(np.float32)
    bands = fft // 2
    a = block // 2
    rot = 2.0 * np.pi * (np.arange(bands) + 0.5) * a / fft  # analysis ref shift
    return w, rot.astype(np.float32)


def _unit(phase: np.ndarray) -> jnp.ndarray:
    p = np.asarray(phase, np.float32)
    return jax.lax.complex(jnp.cos(jnp.asarray(p)), jnp.sin(jnp.asarray(p)))


def _ri(z: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def _cx(a: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(a[..., 0], a[..., 1])


def _scan_hops(cfg, state, cur, prev, time_factor, mult, limit,
               formant_factor=None, formant_compensation=None, formant_base=None):
    """lax.scan of spectral_hop over hops.  Complex arrays cross the scan
    boundary as stacked [..., 2] float32 pairs (the carry layout the
    batched path shares)."""
    st_r = state._replace(prev_output=_ri(state.prev_output))

    def body(st_r, x):
        cur_r, prev_r = x
        st = st_r._replace(prev_output=_cx(st_r.prev_output))
        st2, out = spectral_hop(
            cfg, st, _cx(cur_r), _cx(prev_r), time_factor, mult, limit,
            formant_factor=formant_factor,
            formant_compensation=formant_compensation,
            formant_base=formant_base,
        )
        return st2._replace(prev_output=_ri(st2.prev_output)), _ri(out)

    st_r, outs_r = jax.lax.scan(body, st_r, (_ri(cur), _ri(prev)))
    return st_r._replace(prev_output=_cx(st_r.prev_output)), _cx(outs_r)


def analyse_frames(cfg: SpectralConfig, audio: jnp.ndarray, ends: jnp.ndarray,
                   zero_head: int = 0):
    """Batched blob analyses: frames ENDING at ``ends``, windowed, zero-
    padded to the fft size, half-bin transformed, zero-phase referenced to
    the frame center.  audio [C, T], ends [H] -> [H, C, bands] complex64.

    ``zero_head``: zero the first ``zero_head`` frame samples before
    windowing — the splitComputation=false PREV-analysis law (the short
    split-off seek never refreshes the first interval of the prev window;
    decoded by store-tracing the blob, tools/golden_wasm/verify_splitoff.py,
    hop-exact across rate 0.25-2.0 x semitones +/-12)."""
    w, rot = _consts(cfg.block, cfg.interval, cfg.fft)
    w = np.asarray(w).copy()
    if zero_head:
        w[:zero_head] = 0.0
    frames = framing.gather_frames(audio, ends.astype(jnp.int32) - cfg.block, cfg.block)
    windowed = frames * jnp.asarray(w)  # [C, H, block]
    padded = jnp.pad(windowed, ((0, 0), (0, 0), (0, cfg.fft - cfg.block)))
    spec = mdft.mdft(padded) * _unit(rot)
    return spec.transpose(1, 0, 2)  # [H, C, bands]


def synthesise_frames(cfg: SpectralConfig, specs: jnp.ndarray) -> jnp.ndarray:
    """Inverse of analyse_frames: [H, C, bands] -> time frames [C, H, block]
    (already synthesis-windowed, ready to overlap-add)."""
    w, rot = _consts(cfg.block, cfg.interval, cfg.fft)
    spec = specs.transpose(1, 0, 2) * jnp.conj(_unit(rot))
    blocks = mdft.imdft(spec, cfg.fft)[..., : cfg.block]
    return blocks * jnp.asarray(w)


@functools.partial(jax.jit, static_argnums=(0, 3, 8, 9))
def _render_jit(
    cfg: SpectralConfig,
    audio: jnp.ndarray,       # [C, T]
    frame_ends: jnp.ndarray,  # [H] int32
    n_out: int,
    time_factor: jnp.ndarray,  # scalar
    mult: jnp.ndarray,
    limit: jnp.ndarray,
    state: SpectralState,
    formants: tuple | None = None,  # static (factor, compensation, base)
    split: bool = True,
):
    h = frame_ends.shape[0]
    if split:
        both = jnp.concatenate([frame_ends, frame_ends - cfg.interval])
        specs = analyse_frames(cfg, audio, both)   # [2H, C, bands]
        cur, prev = specs[:h], specs[h:]
    else:
        # split-off prev law: window ending at inputEnd - interval with
        # its first `interval` samples zeroed (see analyse_frames)
        cur = analyse_frames(cfg, audio, frame_ends)
        prev = analyse_frames(cfg, audio, frame_ends - cfg.interval,
                              zero_head=cfg.interval)
    kw = {}
    if formants is not None:
        ff, fc, fb = formants
        kw = dict(
            formant_factor=jnp.float32(ff),
            formant_compensation=jnp.float32(fc),
            formant_base=jnp.float32(fb),
        )
    state, outs = _scan_hops(cfg, state, cur, prev, time_factor, mult, limit, **kw)
    frames = synthesise_frames(cfg, outs)      # [C, H, block]
    ola = framing.overlap_add(frames, cfg.interval, n_out)
    if split:
        # measured placement: frame h lands at (h+1)*interval — shift right
        out = jnp.pad(ola, ((0, 0), (cfg.interval, 0)))[:, :n_out]
    else:
        # split off: frame h lands at h*interval (one interval less latency)
        out = ola[:, :n_out]
    return state, out


#: streaming fidelity state — a plain pytree: (SpectralState, ola_tail)
FidelityState = tuple


def fidelity_chunk(
    cfg: SpectralConfig,
    state,
    audio: jnp.ndarray,       # [C, T]
    frame_ends: jnp.ndarray,  # [H] int32
    time_factor: jnp.ndarray,
    mult: jnp.ndarray,
    limit: jnp.ndarray,
    active: jnp.ndarray,      # scalar 0/1
    formant_factor: jnp.ndarray | None = None,   # needs cfg.formants
    formant_compensation: jnp.ndarray | None = None,
    formant_base: jnp.ndarray | None = None,
):
    """Streaming step: render H hops, emit exactly H*interval samples.

    state = (SpectralState, ola_tail [C, block + interval]).  Hop h's
    synthesized frame lands at chunk-local samples [(h+1)*I, (h+1)*I+block)
    (the measured split-on placement); contributions past the emitted chunk
    carry in the OLA tail.  Inactive voices keep their spectral state
    frozen and emit silence (the reference zeroes input instead — we skip
    the work entirely, a deliberate improvement the reference itself notes
    as a TODO, app/SignalsmithStretch.mjs:868-869).
    """
    # one-stream wrapper over the batched path: on the GPU the sequential
    # band chain then runs in the Triton bandchain kernel (stream-padded to
    # one tile), on the CPU the vmapped scan (same formulas)
    one = lambda x: jnp.asarray(x)[None]
    states = jax.tree.map(one, state)
    args = [one(audio), one(frame_ends), one(time_factor), one(mult),
            one(limit), one(active)]
    kw = {}
    if formant_factor is not None:
        kw = dict(
            formant_factor=one(formant_factor),
            formant_compensation=one(formant_compensation),
            formant_base=one(formant_base),
        )
    new_states, emit = batched_fidelity_chunk(cfg, states, *args, **kw)
    return jax.tree.map(lambda x: x[0], new_states), emit[0]


def _ola_emit(cfg: SpectralConfig, frames, tail, active, h: int):
    """Overlap-add + tail carry for one stream: frame ``i`` lands at chunk
    samples [(i+1)*interval, (i+1)*interval + block) with split on (the
    measured placement), [i*interval, i*interval + block) with split off;
    contributions past the emitted chunk carry in the tail (always
    block + interval wide, so the state pytree shape is mode-invariant)."""
    interval, block = cfg.interval, cfg.block
    ola = framing.overlap_add(frames, interval, h * interval + block)
    if cfg.split:
        ola = jnp.pad(ola, ((0, 0), (interval, 0)))  # frames start at +I
    else:
        ola = jnp.pad(ola, ((0, 0), (0, interval)))  # keep tail width
    ola = ola.at[:, : block + interval].add(tail)
    emit = ola[:, : h * interval] * active
    new_tail = ola[:, h * interval :]
    return emit, new_tail


def _analyse_many(cfg: SpectralConfig, audios, ends, zero_head: int = 0):
    """Batched analyses across the pool: [S, C, T] x [S, F] ends ->
    [S, F, C, bands] (a vmapped :func:`analyse_frames`: one contiguous
    ``block``-sample fetch per frame)."""
    return jax.vmap(
        lambda au, en: analyse_frames(cfg, au, en, zero_head=zero_head)
    )(audios, ends)


def _analyse_cur_prev(cfg: SpectralConfig, audios, ends, full_prev=False):
    """Batched cur/prev analyses for a pool chunk ([S, H] ends ->
    [H, S, C, bands] each), honoring the splitComputation mode: with split
    on both frame families analyse in ONE batched pass; with split off the
    prev windows zero their first interval (the decoded split-off law).

    ``full_prev`` forces the full-window prev analysis even when
    cfg.split is off — the COUPLED (live-input) drive: the zero-head
    artifact comes from the seek path's short prev refresh, and the live
    branch never seeks (its per-sample ring writes keep the whole window
    fresh; lockstep-verified 2026-08-20, a zero-head prev errs O(1))."""
    h = ends.shape[1]
    if cfg.split or full_prev:
        both = jnp.concatenate([ends, ends - cfg.interval], axis=1)  # [S, 2H]
        specs = _analyse_many(cfg, audios, both)
        cur = jnp.moveaxis(specs[:, :h], 1, 0)    # [H, S, C, bands]
        prev = jnp.moveaxis(specs[:, h:], 1, 0)
        return cur, prev
    cur = _analyse_many(cfg, audios, ends)
    prev = _analyse_many(cfg, audios, ends - cfg.interval,
                         zero_head=cfg.interval)
    return jnp.moveaxis(cur, 1, 0), jnp.moveaxis(prev, 1, 0)


def init_fidelity_state(cfg: SpectralConfig):
    return (
        init_spectral_state(cfg),
        jnp.zeros((cfg.channels, cfg.block + cfg.interval), jnp.float32),
    )


def init_batched_fidelity_state(cfg: SpectralConfig, capacity: int):
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (capacity,) + x.shape).copy(),
        init_fidelity_state(cfg),
    )


def batched_fidelity_chunk(
    cfg: SpectralConfig, states, audios, ends, tf, mult, limit, active,
    formant_factor=None, formant_compensation=None, formant_base=None,
    coupled=False,
):
    """Whole-pool fidelity step, hop-parallel form (round-3 serving path).

    Structure (bit-identical math to :func:`batched_fidelity_chunk_scan`,
    the original hop-scan form — enforced by tests/test_spectral.py):

    1. batched MDFT analyses for all hops/streams (unchanged);
    2. ``engine.spectral.chain_inputs_hops``: ALL hop-local work — the
       bidirectional smoothers, peak maps, MINSTD draw streams, the five
       gather families, the formant chain, the stale-prediction
       denominators — precomputed for the whole chunk in one batched pass
       (recomputed inside the hop scan this stage dominated the step);
    3. a light ``lax.scan`` over hops whose body is only the state-coupled
       tail: rotate the carried spectrum, the time-prediction products, the
       leader-selected ``u12``, and the sequential band chain
       (``engine.spectral.band_chain_batched``: the Triton kernel on the
       GPU);
    4. batched inverse MDFT + overlap-add (unchanged).
    """
    from bauklank.engine.spectral import (
        _unit_phase,
        band_chain_batched,
        chain_inputs_hops,
    )

    spec_states, tails = states
    h = ends.shape[1]
    interval, block = cfg.interval, cfg.block
    # coupled (live) drive: full-window prev even under split-off — only
    # the PLACEMENT half of the split-off law applies (no seek, so the
    # zero-head prev artifact never occurs); see _analyse_cur_prev
    cur, prev = _analyse_cur_prev(cfg, audios, ends, full_prev=coupled)

    xs, (rng_final, fv, fw) = chain_inputs_hops(
        cfg, spec_states, cur, prev, tf, mult, limit,
        formant_factor, formant_compensation, formant_base,
    )
    # complex leaves ride the scan as stacked [..., 2] f32 pairs
    cplx = {"d1", "d2", "k1", "k2", "tw", "pi_mc", "lock", "pred_input"}
    xs_r = {k: (_ri(v) if k in cplx else v) for k, v in xs.items()}
    rot = _unit_phase(
        2.0 * np.pi * (np.arange(cfg.bands) + 0.5) * interval / cfg.fft
    )
    long_step, c_n = cfg.long_step, cfg.channels

    def body(prev_out_r, x):
        p_out = _cx(prev_out_r) * rot[None, None]            # [S, C, B]
        timepred = p_out * _cx(x["tw"]) / x["den"].astype(jnp.complex64)
        zeros1 = jnp.zeros(timepred.shape[:-1] + (1,), timepred.dtype)
        zerosL = jnp.zeros(timepred.shape[:-1] + (long_step,), timepred.dtype)
        tp1 = jnp.concatenate([timepred[..., 1:], zeros1], axis=-1)
        tpL = jnp.concatenate([timepred[..., long_step:], zerosL], axis=-1)
        u12 = jnp.sum(tp1 * _cx(x["k1"]), axis=1) + jnp.sum(
            tpL * _cx(x["k2"]), axis=1
        )                                                     # [S, B]
        chain = (
            _cx(x["d1"]), _cx(x["d2"]), u12, x["pe_mc"], _cx(x["pi_mc"]),
            x["mc"], _cx(x["lock"]), x["pred_energy"], _cx(x["pred_input"]),
        )
        out = band_chain_batched(cfg, chain)
        return _ri(out), _ri(out)

    prev_out_r, outs_r = jax.lax.scan(
        body, _ri(spec_states.prev_output), xs_r
    )
    new_spec_state = spec_states._replace(
        prev_output=_cx(prev_out_r),
        prev_pred_energy=xs["pred_energy"][-1],
        rng=rng_final,
        f_value_ema=fv,
        f_weighted_ema=fw,
    )
    outs = jnp.moveaxis(_cx(outs_r), 0, 1)    # [S, H, C, bands]
    frames = jax.vmap(lambda o: synthesise_frames(cfg, o))(outs)  # [S, C, H, blk]
    emit, new_tails = jax.vmap(
        lambda fr, tl, a: _ola_emit(cfg, fr, tl, a, h)
    )(frames, tails, active)
    # freeze state while inactive (per stream)
    def freeze(a, b):
        mask = active.reshape((-1,) + (1,) * (a.ndim - 1)) > 0
        return jnp.where(mask, a, b)

    new_spec_state = jax.tree.map(freeze, new_spec_state, spec_states)
    new_tails = freeze(new_tails, tails)
    return (new_spec_state, new_tails), emit


def batched_fidelity_chunk_scan(
    cfg: SpectralConfig, states, audios, ends, tf, mult, limit, active,
    formant_factor=None, formant_compensation=None, formant_base=None,
):
    """The original hop-scan form (chain inputs recomputed inside the hop
    scan via spectral_hop_batched).  Kept as the cross-check oracle for the
    hop-parallel serving path above — tests pin the two equal."""
    from bauklank.engine.spectral import spectral_hop_batched

    spec_states, tails = states
    h = ends.shape[1]
    interval, block = cfg.interval, cfg.block
    cur, prev = _analyse_cur_prev(cfg, audios, ends)

    st_r = spec_states._replace(prev_output=_ri(spec_states.prev_output))

    def body(st_r, x):
        cur_r, prev_r = x
        st = st_r._replace(prev_output=_cx(st_r.prev_output))
        st2, out = spectral_hop_batched(
            cfg, st, _cx(cur_r), _cx(prev_r), tf, mult, limit,
            formant_factor, formant_compensation, formant_base,
        )
        return st2._replace(prev_output=_ri(st2.prev_output)), _ri(out)

    st_r, outs_r = jax.lax.scan(body, st_r, (_ri(cur), _ri(prev)))
    new_spec_state = st_r._replace(prev_output=_cx(st_r.prev_output))
    outs = jnp.moveaxis(_cx(outs_r), 0, 1)    # [S, H, C, bands]
    frames = jax.vmap(lambda o: synthesise_frames(cfg, o))(outs)  # [S, C, H, blk]
    emit, new_tails = jax.vmap(
        lambda fr, tl, a: _ola_emit(cfg, fr, tl, a, h)
    )(frames, tails, active)
    # freeze state while inactive (per stream)
    def freeze(a, b):
        mask = active.reshape((-1,) + (1,) * (a.ndim - 1)) > 0
        return jnp.where(mask, a, b)

    new_spec_state = jax.tree.map(freeze, new_spec_state, spec_states)
    new_tails = freeze(new_tails, tails)
    return (new_spec_state, new_tails), emit


def live_fidelity_ring_len(cfg: SpectralConfig, hops: int) -> int:
    """Input-ring length for the coupled (live-input) fidelity drive: the
    oldest window a chunk of ``hops`` hops reads is the PREV analysis of its
    first hop — ``block + interval`` samples before that hop's window end,
    which itself sits ``hops * interval`` before the ring's write head."""
    return cfg.block + (hops + 1) * cfg.interval


def init_batched_live_fidelity_state(cfg: SpectralConfig, hops: int,
                                     capacity: int):
    """(SpectralState, ola_tail, input_ring) per stream, batched.  The ring
    starts zeroed — exactly the blob's freshly-reset input ring (silence
    before the stream starts)."""
    spec, tails = init_batched_fidelity_state(cfg, capacity)
    rings = jnp.zeros(
        (capacity, cfg.channels, live_fidelity_ring_len(cfg, hops)), jnp.float32
    )
    return (spec, tails, rings)


def batched_live_fidelity_chunk(
    cfg: SpectralConfig, states, chunks, mult, limit, active,
    formant_factor=None, formant_compensation=None, formant_base=None,
):
    """Blob-exact COUPLED (live-input) pool step: consume
    ``chunks [S, C, H*interval]`` of live input per stream, emit the same
    number of processed samples.

    The reference live branch copies each render quantum into the input
    planes and calls ``_process(N, N)`` (app/SignalsmithStretch.mjs:870-882,
    no seek).  Decoded consequences (docs/WASM-ALGO.md per-hop step 1):

    - input fills the ring in lockstep with output (``inputSamples ==
      outputSamples``), so when hop ``h`` fires at output-counter sample
      ``o = h*interval`` the ring holds exactly the first ``o`` input
      samples — the analysis windows end ``(H - i)*interval`` before the
      ring's write head for chunk-local hop ``i``;
    - the effective timeFactor is ``interval / max(advance, 1) = 1`` (the
      ring advances exactly one interval per hop), so the deterministic
      tf <= 2 regime always holds and the MINSTD stream is never consumed;
    - all hop math is the file-mode math — this delegates to
      :func:`batched_fidelity_chunk` with a rolling ring as the audio and
      CONSTANT relative frame ends (no per-step host work at all);
    - under splitComputation=false only the PLACEMENT half of the
      split-off law applies (frames land at ``o`` instead of ``o +
      interval``): the zero-head prev artifact is a seek-path effect and
      the live branch never seeks (``coupled=True`` below;
      lockstep-verified, golden case ``live_stp12_splitoff``).

    state = (SpectralState, ola_tail, ring [C, L]) per stream (see
    :func:`init_batched_live_fidelity_state`).
    """
    spec_states, tails, rings = states
    s, c, n = chunks.shape
    interval = cfg.interval
    h = n // interval
    assert h * interval == n, (n, interval)
    el = rings.shape[-1]
    rings = jnp.concatenate(
        [rings[:, :, n:], chunks.astype(jnp.float32)], axis=-1
    )
    ends = el - (h - jnp.arange(h, dtype=jnp.int32)) * interval
    ends = jnp.broadcast_to(ends[None], (s, h))
    tf = jnp.ones((s,), jnp.float32)
    kw = {}
    if formant_factor is not None:
        kw = dict(
            formant_factor=formant_factor,
            formant_compensation=formant_compensation,
            formant_base=formant_base,
        )
    (spec_states, tails), emit = batched_fidelity_chunk(
        cfg, (spec_states, tails), rings, ends, tf, mult, limit, active,
        coupled=True, **kw
    )
    return (spec_states, tails, rings), emit


def render_fidelity(
    audio: np.ndarray,
    sample_rate: float,
    n_out: int,
    rate: float = 1.0,
    semitones: float = 0.0,
    tonality_hz: float = 8000.0,
    block_ms: float = 120.0,
    interval_ms: float = 30.0,
    state: SpectralState | None = None,
    seed: int = 1,
    formant_semitones: float = 0.0,
    formant_compensation: bool = False,
    formant_base_hz: float = 0.0,
    split_computation: bool = True,
) -> np.ndarray:
    """Render ``n_out`` frames — same signature/semantics as the golden
    harness' native.render_reference.  audio [C, T] float32."""
    sr = float(sample_rate)
    block = round(block_ms / 1000 * sr)
    interval = round(interval_ms / 1000 * sr)
    use_formants = formant_semitones != 0.0 or formant_compensation
    cfg = SpectralConfig(
        channels=audio.shape[0], block=block, interval=interval,
        formants=use_formants,
    )
    n_hops = -(-n_out // interval)
    ends = hop_frame_ends(cfg, n_hops, rate, sr, split=split_computation)
    mult = float(np.exp2(semitones / 12.0))
    limit = (tonality_hz / sr) / np.sqrt(mult)
    if state is None:
        state = init_spectral_state(cfg, seed=seed)
    formants = None
    if use_formants:
        formants = (
            float(np.exp2(formant_semitones / 12.0)),
            1.0 if formant_compensation else 0.0,
            formant_base_hz / sr,
        )
    _, out = _render_jit(
        cfg,
        jnp.asarray(audio, jnp.float32),
        jnp.asarray(ends),
        int(n_out),
        # blob seek law: timeFactor = f32(min(1/rate, interval)) — the
        # stored tf at 6156 saturates at `interval` once the rate advances
        # less than one input sample per hop (probed round 5; only reachable
        # at rate < 1/interval, e.g. rate 1e-5 on the control surface)
        jnp.float32(min(1.0 / rate, float(interval))),
        jnp.float32(mult),
        jnp.float32(limit),
        state,
        formants,
        bool(split_computation),
    )
    return np.asarray(out)
