"""Dynamic per-stream stretch parameters (a traced pytree).

These are the *runtime* controls — the reference sets them every render
quantum from the current time-map segment
(``_setTransposeSemitones(semitones, tonalityHz/sampleRate)``,
``_setFormantSemitones(semitones, compensation)``,
``_setFormantBase(freqNormalized)`` — reference:
app/SignalsmithStretch.mjs:845-849).  In this engine they are a pytree of
arrays with a leading stream axis so 64+ streams with independent controls
run in one batched dispatch (BASELINE config 5).

All frequencies are normalized to cycles/sample (Hz / sample_rate).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = ["StretchParams", "semitones_to_factor"]


def semitones_to_factor(semitones):
    return 2.0 ** (jnp.asarray(semitones, jnp.float32) / 12.0)


class StretchParams(NamedTuple):
    """Per-stream dynamic controls.  Every field is float32 [...] (scalar for
    a single stream; leading stream axis when batched)."""

    active: jnp.ndarray            # 0/1 — inactive streams emit silence
    rate: jnp.ndarray              # input samples consumed per output sample
    transpose_factor: jnp.ndarray  # frequency multiplier (2^(semitones/12))
    tonality: jnp.ndarray          # tonality limit, cycles/sample; <=0 -> off
    formant_factor: jnp.ndarray    # formant envelope ratio
    formant_compensation: jnp.ndarray  # 0/1
    formant_base: jnp.ndarray      # envelope scale, cycles/sample; 0 -> detect

    @classmethod
    def make(
        cls,
        *,
        active=1.0,
        rate=1.0,
        semitones=0.0,
        transpose_factor=None,
        tonality_hz=8000.0,
        formant_semitones=0.0,
        formant_factor=None,
        formant_compensation=0.0,
        formant_base_hz=0.0,
        sample_rate=44100.0,
    ) -> "StretchParams":
        """Build params from reference-style controls (Hz / semitones).

        Defaults mirror the reference worklet's initial timeMap segment
        (app/SignalsmithStretch.mjs:588-601): rate 1, semitones 0,
        tonalityHz 8000, formant off, base 0 = detect.
        """
        tf = (
            jnp.asarray(transpose_factor, jnp.float32)
            if transpose_factor is not None
            else semitones_to_factor(semitones)
        )
        ff = (
            jnp.asarray(formant_factor, jnp.float32)
            if formant_factor is not None
            else semitones_to_factor(formant_semitones)
        )
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return cls(
            active=f32(active),
            rate=f32(rate),
            transpose_factor=tf,
            tonality=f32(np.asarray(tonality_hz) / sample_rate),
            formant_factor=ff,
            formant_compensation=f32(formant_compensation),
            formant_base=f32(np.asarray(formant_base_hz) / sample_rate),
        )

    @classmethod
    def stack(cls, params_list) -> "StretchParams":
        """Stack single-stream params into a batched [streams] pytree."""
        return cls(*[jnp.stack([getattr(p, f) for p in params_list]) for f in cls._fields])
