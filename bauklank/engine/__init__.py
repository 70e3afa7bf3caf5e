"""The streaming stretch engine (state pytree + jitted step functions).

Two engine cores share the node/pool/serving surfaces:

- ``engine.core`` — the "fast" accelerator-first engine: hop-parallel associative-
  scan phase vocoder, no sequential loops, maximum throughput.
- ``engine.spectral`` + ``engine.fidelity`` — the "fidelity" engine: the
  reference blob's exact algorithm (reverse-engineered, docs/WASM-ALGO.md),
  >=40 dB vs the actual reference renderer (tests/test_golden_wasm.py).
"""

from bauklank.engine.config import StretchConfig, preset_default, preset_cheaper
from bauklank.engine.params import StretchParams
from bauklank.engine.core import init_state, process_chunk, StretchState
from bauklank.engine.offline import stretch_offline
from bauklank.engine.fidelity import render_fidelity, SpectralConfig

__all__ = [
    "StretchConfig",
    "SpectralConfig",
    "StretchParams",
    "StretchState",
    "init_state",
    "process_chunk",
    "stretch_offline",
    "render_fidelity",
    "preset_default",
    "preset_cheaper",
]
