"""The stretch engine core: hop-parallel spectral processing.

Algorithm (a hop-parallel re-derivation of the reference engine's behavior —
the reference ships it only as an opaque WASM phase vocoder, reference:
app/SignalsmithStretch.mjs:265 and SURVEY.md §2.1):

For each synthesis hop ``h`` (output frames placed every ``interval``
samples), analyze the input at the mapped position ``p_h`` *and* at
``p_h - interval``.  The per-band phase advance measured between those two
analyses is exactly the advance one output hop must add — independent of the
stretch rate, which is why the reference can "constantly re-seek" with a
rate-independent buffer (app/SignalsmithStretch.mjs:934-935).  Output bands
are read from pitch-mapped input bands (tonality-limited mapping,
:mod:`bauklank.ops.pitchmap`) and rotated so each band's phase continues
from where the previous output hop left off; a constant extra rotation of
``2*pi*(f_out - f_in)*interval`` per hop realizes the pitch shift.

The parallel reformulation: the output is ``out_h = rot_h * cur_h`` with one
shared unit rotation per band (preserving intra-hop spectral and
inter-channel phase structure), and the rotation recursion

    rot_h = rot_{h-1} * a_h * b_h            (see hop_factors for a_h, b_h)

is a cumulative complex product of per-hop factors computable from input
analyses alone — optionally generalized to a "last reset wins" semigroup for
transient phase re-anchoring (rotation_scan).  So a whole chunk of hops runs
as: one batched windowed frame fetch -> one batched MDFT
over all (cur, prev) frames -> elementwise factor computation ->
``lax.associative_scan`` (parallel prefix) over hops -> batched inverse MDFT
-> one overlap-add.  No sequential per-hop loop anywhere; the only carried
state between chunks is (rot, last mapped spectrum, OLA tail).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.config import StretchConfig
from bauklank.engine.params import StretchParams
from bauklank.ops import formant as formant_ops
from bauklank.ops import framing, mdft, pitchmap, windows

__all__ = [
    "StretchState",
    "init_state",
    "process_chunk",
    "hop_factors",
    "rotation_scan",
    "flush",
]


class StretchState(NamedTuple):
    """Per-stream carried state (a pytree; batch with a leading stream axis)."""

    rot: jnp.ndarray       # [bins] complex64 — accumulated band rotation
    prev_cur: jnp.ndarray  # [C, bins] complex64 — last hop's mapped spectrum
    ola_tail: jnp.ndarray  # [C, block] float32 — synthesized, not yet emitted


_FUSED_MDFT: bool | None = None  # None = the BAUKLANK_FUSED_MDFT env var


def _use_fused_mdft() -> bool:
    """Fast-engine MDFT A/B knob for the folded matmul Cooley-Tukey forms
    (ops/mdft.mdft_fused), which fold the center-phase / window / unpack
    diagonals into the matmul stage constants.  OFF by default (jnp.fft
    plus XLA's own elementwise fusion is the default form; the fused form
    is not measured on the GPU).  Set BAUKLANK_FUSED_MDFT=1 to measure."""
    if _FUSED_MDFT is not None:
        return _FUSED_MDFT
    env = os.environ.get("BAUKLANK_FUSED_MDFT")
    if env is not None:
        return env not in ("0", "false", "off")
    return False


def init_state(config: StretchConfig) -> StretchState:
    """Fresh state — the reference `_reset` (app/SignalsmithStretch.mjs:467).

    Created inside a jitted builder so complex zeros/ones materialize
    on-device.
    """
    return _init_state_jit(config)


@functools.partial(jax.jit, static_argnums=(0,))
def _init_state_jit(config: StretchConfig) -> StretchState:
    ones = jax.lax.complex(jnp.ones((config.bins,), jnp.float32), jnp.zeros((config.bins,), jnp.float32))
    zeros_c = jnp.zeros((config.channels, config.bins), jnp.complex64)
    return StretchState(
        rot=ones.astype(jnp.complex64),
        prev_cur=zeros_c,
        ola_tail=jnp.zeros((config.channels, config.block), jnp.float32),
    )


@functools.lru_cache(maxsize=32)
def _window_consts(block: int, interval: int, beta: float | None = None):
    # numpy (not jnp): jnp.asarray inside a jit trace returns a Tracer, which
    # must not be cached across traces.  numpy constants embed as literals.
    wa, ws = windows.pr_window_pair(block, interval, beta=beta)
    freqs = mdft.band_freqs(block)
    return wa, ws, freqs


@functools.lru_cache(maxsize=32)
def _lobe_alpha(block: int, interval: int, beta: float | None = None) -> float:
    """Gaussian model of the analysis window's spectral main lobe:
    |G(x bins)| ~= exp(-alpha x^2), calibrated at x = 1 bin."""
    wa, _ = windows.pr_window_pair(block, interval, beta=beta)
    n = np.arange(block)
    center = (block - 1) / 2.0
    g0 = np.abs(np.sum(wa))
    g1 = np.abs(np.sum(wa * np.exp(-2j * np.pi * (1.0 / block) * (n - center))))
    return float(-np.log(max(g1 / g0, 1e-6)))


def _center_phase(bins: int) -> jnp.ndarray:
    """Zero-phase (frame-center) referencing rotation, e^{i pi (k+1/2)}.

    Analysis spectra are rotated so the window's spectral lobe is phase-flat
    (referenced to the frame center instead of the frame start).  Without
    this, moving a band's content to a different output band under pitch
    shift keeps the *input-space* linear phase, adjacent output bands land
    up to ~90 degrees misaligned, and the overlap-add partially cancels —
    measured as a several-dB-down shifted tone with strong frame-rate
    sidebands.  With center referencing the lobe is (near-)real and band
    relocation preserves coherence; synthesis applies the conjugate.
    Built in-graph from real constants.
    """
    sign = np.where(np.arange(bins) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return jax.lax.complex(jnp.zeros((bins,), jnp.float32), jnp.asarray(sign))


def process_chunk(
    config: StretchConfig,
    state: StretchState,
    audio: jnp.ndarray,
    frame_ends: jnp.ndarray,
    params: StretchParams,
):
    """Process ``H`` hops for one stream; jit/vmap-safe.

    config:     static shapes.
    state:      carried :class:`StretchState`.
    audio:      [C, T] device-resident source samples (a loaded track, or a
                seek window — out-of-range reads are zero, matching the
                reference's zero-padded seek fill,
                app/SignalsmithStretch.mjs:905-931).
    frame_ends: [H] int32 — per hop, the *exclusive end* of the current
                analysis frame in ``audio``.  For time alignment, hop ``h``
                (output samples [h*I, h*I + block)) should use
                ``frame_ends[h] = round(input_center_h) + block//2`` where
                ``input_center_h`` is the input position mapped from the
                output frame center.
    params:     dynamic controls (scalars for a single stream).

    Returns ``(new_state, out)`` with ``out`` float32 [C, H*interval].
    """
    block, interval = config.block, config.interval
    _, ws, _ = _window_consts(block, interval, config.window_beta)
    h = frame_ends.shape[0]

    v, cur_m, gain, reset = hop_factors(config, audio, frame_ends, params, state.prev_cur)
    rot_seq = rotation_scan(state.rot, v, reset)
    out_spec = rot_seq[None] * cur_m
    if gain is not None:
        out_spec = out_spec * gain

    # --- synthesis + overlap-add ---------------------------------------------
    if _use_fused_mdft():
        out_frames = mdft.imdft_fused(
            out_spec, block, window=jnp.asarray(ws), center_phase_conj=True
        )  # [C, H, B]
    else:
        out_spec = out_spec * jnp.conj(_center_phase(config.bins))
        out_frames = mdft.imdft(out_spec, block) * ws  # [C, H, B]
    ola = framing.overlap_add(out_frames, interval, h * interval + block)
    total = ola.at[:, :block].add(state.ola_tail)
    emit = total[:, : h * interval] * params.active
    new_tail = total[:, h * interval : h * interval + block]

    new_state = StretchState(
        rot=pitchmap.unit(rot_seq[-1]),
        prev_cur=cur_m[:, -1],
        ola_tail=new_tail,
    )
    return new_state, emit


def hop_factors(
    config: StretchConfig,
    audio: jnp.ndarray,
    frame_ends: jnp.ndarray,
    params: StretchParams,
    prev_cur: jnp.ndarray,
):
    """Per-hop spectral quantities: rotation factors ``v`` [H, bins], mapped
    spectra ``cur_m`` [C, H, bins], and formant ``gain`` (or None).

    Factored out of :func:`process_chunk` so hop-sharded multi-chip renders
    (bauklank.parallel.seqpar) can compute local factors and compose the
    global prefix product with collectives.
    """
    block, interval = config.block, config.interval
    wa, _, band_f = _window_consts(block, interval, config.window_beta)
    h = frame_ends.shape[0]

    # --- batched analysis: cur frames and prev (one interval earlier) ------
    starts_cur = frame_ends.astype(jnp.int32) - block
    starts = jnp.concatenate([starts_cur, starts_cur - interval])  # [2H]
    windowed = framing.gather_frames(audio, starts, block) * wa
    if _use_fused_mdft():
        specs = mdft.mdft_fused(windowed, center_phase=True)  # [C, 2H, bins]
    else:
        specs = mdft.mdft(windowed) * _center_phase(block // 2)
    cur = specs[:, :h]

    # --- pitch-mapped band gather (one einsum for cur+prev) -----------------
    limit = pitchmap.effective_tonality_limit(params.transpose_factor, params.tonality)
    pos, dfreq = pitchmap.source_positions(band_f, params.transpose_factor, limit, block)
    specs_m = pitchmap.gather_fractional(specs, pos)  # [C, 2H, bins]
    cur_m, prev_m = specs_m[:, :h], specs_m[:, h:]

    # --- per-hop rotation factors --------------------------------------------
    # Output phase rule (deviation scaling): each output band's phase must
    # advance per hop by
    #     2*pi*f_out_center*I  +  g * dev_h
    # where dev_h is the measured deviation of the input content from its
    # band center — angle(w_h * e^{-2i pi f_in_center I}) with
    # w_h = unit(sum_c cur_h * conj(prev_h)) the rate-independent one-
    # interval advance measurement — and g is the local frequency-map
    # gradient (= transpose factor below the tonality limit, 1 above it).
    # Scaling the *deviation* (not the wrapped total) is what keeps adjacent
    # bands frequency-consistent under pitch shift; preserving it unscaled
    # makes a shifted tone split between bands and beat.
    #
    # Since out_h = rot_h * cur_h, the required update factors in the
    # carried rotation are
    #     rot_h = rot_{h-1} * a_h * b_h
    #     a_h = unit(sum_c cur_{h-1} * conj(cur_h))   (cancel cur progression)
    #     b_h = exp(i*(2 pi f_out I + g * dev_h))     (impose desired advance)
    # — every factor is computable from input analyses alone, so the whole
    # chunk is still one associative_scan (parallel prefix) over hops.
    prev_hop_cur = jnp.concatenate([prev_cur[:, None], cur_m[:, : h - 1]], axis=1)
    f_in = band_f - dfreq  # [bins] source frequency per output band
    grad = jnp.where(band_f <= limit * params.transpose_factor, params.transpose_factor, 1.0)
    two_pi_i = jnp.float32(2.0 * np.pi * interval)

    w = pitchmap.unit(jnp.sum(cur_m * jnp.conj(prev_m), axis=0))  # [H, bins]
    dev = jnp.angle(w * jnp.exp(-1j * two_pi_i * f_in))           # in (-pi, pi]
    corr_a = jnp.sum(prev_hop_cur * jnp.conj(cur_m), axis=0)
    v = (pitchmap.unit(corr_a) * jnp.exp(1j * (two_pi_i * band_f + grad * dev))).astype(jnp.complex64)
    # Phase (re)start: with no previous-output energy in a band (first hop
    # after reset, or silence -> signal), there is no phase to continue —
    # keep the current rotation so the output phase restarts from the input
    # phase.  (The reference engine behaves the same way after _reset.)
    v = jnp.where(jnp.abs(corr_a) > 1e-12, v, jnp.complex64(1.0))

    # Lobe-consistent magnitude correction: the gathered band magnitudes
    # follow the window lobe sampled at *input*-space deviations L(delta);
    # a coherent tone at the realized output frequency needs L(g*delta).
    # Rescaling by L(g*delta)/L(delta) (Gaussian lobe model) makes the
    # cross-band magnitude profile consistent, which deepens the OLA's
    # cancellation of frame-rate aliases — measured -21 dB -> -45 dB
    # sidebands at +12 st, overlap ~4, for < 1 dB broadband cost.
    # grad == 1 (no shift / above the tonality limit) => exactly 1.
    alpha = jnp.float32(_lobe_alpha(block, interval, config.window_beta))
    delta = dev * jnp.float32(block / (2.0 * np.pi * interval))  # input bins
    gain = jnp.clip(
        jnp.exp(-alpha * (jnp.square(grad) - 1.0) * jnp.square(delta)), 0.05, 4.0
    )[None, :, :]

    if config.formants:
        # channel-summed envelope: one smoother for all channels (a shared
        # spectral shape is the usual stereo formant model, and it halves
        # the envelope FFT work)
        psum = jnp.sum(jnp.square(jnp.abs(cur)), axis=0)  # [H, bins]
        f0 = formant_ops.detect_f0_bands(psum)  # [H]
        base_bands = params.formant_base * block
        sigma = 0.5 * jnp.where(base_bands > 0, base_bands, f0)  # [H]
        env = formant_ops.spectral_envelope(psum, sigma)  # [H, bins]
        gain = gain * formant_ops.formant_gain(
            env, band_f, pos, params.formant_factor, params.formant_compensation,
            params.transpose_factor, limit, block,
        )

    # Transient detection: per-band onset = energy jump over one interval.
    if config.transient_reset_db is not None:
        thresh = jnp.float32(10.0 ** (config.transient_reset_db / 10.0))
        e_cur = jnp.sum(jnp.square(jnp.abs(cur_m)), axis=0)    # [H, bins]
        e_prev = jnp.sum(jnp.square(jnp.abs(prev_m)), axis=0)
        reset = (e_cur > thresh * (e_prev + 1e-12)) & (e_cur > 1e-10)
    else:
        reset = jnp.zeros(v.shape, bool)
    return v, cur_m, gain, reset


def rotation_scan(rot0: jnp.ndarray, v: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    """Cumulative rotation with per-band resets, as one parallel prefix.

    rot_h = 1 where reset_h else rot_{h-1} * v_h, seeded with ``rot0``.
    The (flag, value) pairs form a "last reset wins" semigroup:
        (ra, za) . (rb, zb) = (ra | rb, zb if rb else za * zb)
    which stays associative, so transient re-anchoring costs nothing in hop
    parallelism.
    """
    ones = jnp.ones_like(v[:1])
    flags = jnp.concatenate([jnp.zeros((1,) + reset.shape[1:], bool), reset], axis=0)
    vals = jnp.concatenate([rot0[None, :], jnp.where(reset, ones, v)], axis=0)

    def comb(a, b):
        ra, za = a
        rb, zb = b
        return jnp.logical_or(ra, rb), jnp.where(rb, zb, za * zb)

    _, zs = jax.lax.associative_scan(comb, (flags, vals), axis=0)
    return zs[1:]


def flush(config: StretchConfig, state: StretchState):
    """Emit the remaining OLA tail and reset it — the reference `_flush`
    (app/SignalsmithStretch.mjs:478).  Returns (state, tail [C, block])."""
    tail = state.ola_tail
    return state._replace(ola_tail=jnp.zeros_like(tail)), tail
