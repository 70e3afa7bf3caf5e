"""Scalar NumPy renderer: the executable specification of the engine.

This is an *independent implementation* of the stretch algorithm — a plain
per-hop float64 loop with none of the batched reformulations (no batched frame
tensor, no interpolation matmuls, no associative scan).  Its role mirrors
what SURVEY.md §4 prescribes for golden-output testing: the JAX engine must
match this renderer to high SNR, which catches vectorization bugs
(alignment, interpolation, phase bookkeeping) that property tests miss.
The actual reference WASM blob can additionally be driven via
tools/golden_wasm when a WASM runtime is available (none in this image).

Algorithm spec (shared with bauklank.engine.core — see its module
docstring for the derivation):

per hop h (output frames every `interval`, analysis frame ends at
``frame_ends[h]``):
  1. cur  = MDFT(window * audio[e-B : e])
     prev = MDFT(window * audio[e-I-B : e-I])
  2. map output band b (center f_out = (b+.5)/B) to source frequency
     f_in = unmap(f_out) under the tonality-limited transpose map;
     gather cur/prev at the fractional source band (linear complex interp).
  3. w = unit(sum_c cur_m * conj(prev_m));  dev = angle(w * e^{-2πi f_in I})
     a = unit(sum_c prev_hop_cur_m * conj(cur_m))
     v = a * exp(i (2π f_out I + grad * dev)),  grad = transpose factor
     below the limit, 1 above;  v = 1 where there is no previous output
     energy.  rot *= v.
  4. out = rot * cur_m * formant_gain;  synthesize via inverse MDFT,
     synthesis window, overlap-add.
"""

from __future__ import annotations

import numpy as np

from bauklank.engine.config import StretchConfig
from bauklank.ops.windows import pr_window_pair

__all__ = ["render_offline"]


def _mdft(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    pre = np.exp(-1j * np.pi * np.arange(n) / n)
    return np.fft.fft(x * pre, axis=-1)[..., : n // 2]


def _imdft(spec: np.ndarray, n: int) -> np.ndarray:
    z = np.zeros(spec.shape[:-1] + (n,), np.complex128)
    z[..., : n // 2] = spec
    t = np.fft.ifft(z, axis=-1) * np.exp(1j * np.pi * np.arange(n) / n)
    return 2.0 * np.real(t)


def _unit(z, eps=1e-20):
    zr = z + eps
    return zr / np.abs(zr)


def _frame(audio: np.ndarray, start: int, block: int) -> np.ndarray:
    c, t = audio.shape
    out = np.zeros((c, block))
    lo, hi = max(0, start), min(t, start + block)
    if lo < hi:
        out[:, lo - start : hi - start] = audio[:, lo:hi]
    return out


def _gather_lin(spec: np.ndarray, pos: np.ndarray, clamp: bool) -> np.ndarray:
    """Linear interp of spec[..., bins] at fractional positions (per band)."""
    bins = spec.shape[-1]
    p = np.clip(pos, 0.0, bins - 1.0) if clamp else pos
    i0 = np.floor(p).astype(int)
    w = p - i0
    out = np.zeros(spec.shape[:-1] + (pos.shape[0],), spec.dtype)
    for b in range(pos.shape[0]):
        lo, hi = i0[b], i0[b] + 1
        s0 = spec[..., lo] if 0 <= lo < bins else 0.0
        s1 = spec[..., hi] if 0 <= hi < bins else 0.0
        out[..., b] = s0 * (1.0 - w[b]) + s1 * w[b]
    return out


def _envelope(power: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian smoothing along bands via reflection + FFT (spec of
    ops.formant.spectral_envelope)."""
    bins = power.shape[-1]
    ext = np.concatenate([power, power[..., ::-1]], axis=-1)
    spec = np.fft.rfft(ext, axis=-1)
    q = np.arange(spec.shape[-1])
    g = np.exp(-2.0 * np.pi**2 * sigma**2 * q**2 / float((2 * bins) ** 2))
    sm = np.fft.irfft(spec * g, n=2 * bins, axis=-1)[..., :bins]
    return np.maximum(sm, 0.0)


def _detect_f0(power_sum: np.ndarray) -> float:
    bins = power_sum.shape[-1]
    ceps = np.abs(np.fft.rfft(np.log(power_sum + 1e-9)))
    q = np.arange(ceps.shape[-1])
    mask = (q >= 8.0) & (q <= bins / 2.0)
    ceps = np.where(mask, ceps, -np.inf)
    qpk = float(np.argmax(ceps))
    return float(np.clip(bins / max(qpk, 1.0), 1.0, bins // 4))


def render_offline(
    audio: np.ndarray,
    rate: float,
    config: StretchConfig,
    n_out: int,
    transpose_factor: float = 1.0,
    tonality: float = 8000.0 / 44100.0,
    formant_factor: float = 1.0,
    formant_compensation: bool = False,
    formant_base: float = 0.0,
    in_start: float = 0.0,
) -> np.ndarray:
    """Render ``n_out`` samples; audio [C, T] float; all frequencies in
    cycles/sample."""
    b, i = config.block, config.interval
    c = audio.shape[0]
    bins = b // 2
    wa, ws = pr_window_pair(b, i, beta=config.window_beta)
    wa = wa.astype(np.float64)
    ws = ws.astype(np.float64)

    f_out = (np.arange(bins) + 0.5) / b
    limit = tonality / np.sqrt(max(transpose_factor, 1e-12)) if tonality > 0 else 0.5
    f_in = np.where(
        f_out <= limit * transpose_factor,
        f_out / max(transpose_factor, 1e-12),
        f_out - limit * (transpose_factor - 1.0),
    )
    pos = f_in * b - 0.5
    grad = np.where(f_out <= limit * transpose_factor, transpose_factor, 1.0)
    two_pi_i = 2.0 * np.pi * i

    n_hops = -(-n_out // i)
    out = np.zeros((c, n_hops * i + b))
    rot = np.ones(bins, np.complex128)
    prev_cur_m = np.zeros((c, bins), np.complex128)

    # zero-phase (frame-center) referencing — see engine.core._center_phase
    cphase = 1j * np.where(np.arange(bins) % 2 == 0, 1.0, -1.0)

    # Gaussian model of the analysis-window main lobe (engine.core._lobe_alpha)
    nn = np.arange(b)
    g0 = np.abs(np.sum(wa))
    g1 = np.abs(np.sum(wa * np.exp(-2j * np.pi * (1.0 / b) * (nn - (b - 1) / 2.0))))
    alpha = -np.log(max(g1 / g0, 1e-6))

    for h in range(n_hops):
        center = in_start + (h * i + b / 2.0) * rate
        e = int(np.round(center)) + b // 2  # np.round: match engine's frame_ends_for
        cur = _mdft(_frame(audio, e - b, b) * wa) * cphase
        prev = _mdft(_frame(audio, e - i - b, b) * wa) * cphase
        cur_m = _gather_lin(cur, pos, clamp=False)
        prev_m = _gather_lin(prev, pos, clamp=False)

        w = _unit(np.sum(cur_m * np.conj(prev_m), axis=0))
        dev = np.angle(w * np.exp(-1j * two_pi_i * f_in))
        corr_a = np.sum(prev_cur_m * np.conj(cur_m), axis=0)
        v = _unit(corr_a) * np.exp(1j * (two_pi_i * f_out + grad * dev))
        v = np.where(np.abs(corr_a) > 1e-12, v, 1.0)
        rot = _unit(rot * v)
        # transient phase re-anchoring (engine.core rotation_scan semantics)
        if config.transient_reset_db is not None:
            e_cur = np.sum(np.abs(cur_m) ** 2, axis=0)
            e_prev = np.sum(np.abs(prev_m) ** 2, axis=0)
            thresh = 10.0 ** (config.transient_reset_db / 10.0)
            reset = (e_cur > thresh * (e_prev + 1e-12)) & (e_cur > 1e-10)
            rot = np.where(reset, 1.0 + 0.0j, rot)

        # lobe-consistent magnitude correction (engine.core.hop_factors)
        delta = dev * (b / (2.0 * np.pi * i))
        lobe_gain = np.clip(np.exp(-alpha * (grad**2 - 1.0) * delta**2), 0.05, 4.0)
        spec_out = rot[None, :] * cur_m * lobe_gain[None, :]

        if config.formants:
            power = np.abs(cur) ** 2
            psum = power.sum(axis=0)
            base_bands = formant_base * b
            sigma = 0.5 * (base_bands if base_bands > 0 else _detect_f0(psum))
            env = _envelope(psum, sigma)  # shared across channels
            f_t = f_out / max(formant_factor, 1e-6)
            f_uncomp = np.where(
                f_t <= limit * transpose_factor,
                f_t / max(transpose_factor, 1e-12),
                f_t - limit * (transpose_factor - 1.0),
            )
            f_target = f_t if formant_compensation else f_uncomp
            pos_t = f_target * b - 0.5
            env_nat = _gather_lin(env, pos, clamp=True)
            env_tgt = _gather_lin(env, pos_t, clamp=True)
            gain = np.sqrt((env_tgt + 1e-9) / (env_nat + 1e-9))
            spec_out = spec_out * np.clip(gain, 0.0, 16.0)

        frame = _imdft(spec_out * np.conj(cphase), b) * ws
        out[:, h * i : h * i + b] += frame
        prev_cur_m = cur_m

    return out[:, :n_out].astype(np.float32)
