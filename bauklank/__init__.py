"""bauklank — batched audio time-stretch + pitch-shift framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
hanskerkhof/BAUKLANK-audio-stretch (a Signalsmith-Stretch-based kiosk:
reference layer map in SURVEY.md §1).  The reference runs one scalar
phase-vocoder voice per AudioWorklet on a Raspberry Pi; this framework runs
hundreds of independent stretch voices as one batched accelerator stream processor.

Subpackages
-----------
ops       Pure-function DSP kernels (windows, MDFT/STFT, band mapping,
          phase rotation, overlap-add, resampling, formants) — JAX + Pallas.
engine    The streaming stretch engine: explicit state pytree + jitted step,
          reproducing the reference WASM ABI semantics
          (reference: app/SignalsmithStretch.mjs:461-479).
schedule  Host-side time-map scheduler (piecewise output→input mapping,
          reference: app/SignalsmithStretch.mjs:656-701).
node      StretchNode-equivalent high-level API
          (reference: app/SignalsmithStretch.mjs:968-1062).
serve     asyncio WebSocket control plane + serial bridge emulation
          (reference: server-multi.py).
parallel  Device-mesh / sharding helpers for multi-chip scale-out.
models    Named engine configurations ("voices") and kiosk presets.
refdsp    Scalar NumPy renderer used as the executable spec in tests.
utils     Audio I/O, version, logging.
"""

from bauklank.engine.config import StretchConfig, preset_default, preset_cheaper
from bauklank.engine.params import StretchParams
from bauklank.utils.version import __version__

__all__ = [
    "StretchConfig",
    "StretchParams",
    "preset_default",
    "preset_cheaper",
    "__version__",
]
