"""Golden-render harness against the reference WASM engine.

SURVEY.md §4 prescribes golden-output tests driven from the exact reference
WASM blob.  Two execution paths, preferred in order:

1. **native** (tools/golden_wasm/native.py): the blob is AOT-translated to
   C by wasm2c.py, compiled with gcc, and driven by a Python re-statement
   of the worklet hot loop.  Needs only a C compiler — works in this image.
2. **node** (tools/golden_wasm/driver.mjs): fakes the worklet scope under
   Node and drives the original JS glue.  Used where node exists, and as a
   cross-check of the native translation.

Run:  python tools/golden_wasm/harness.py --rate 0.5 --semitones 0
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

REFERENCE = pathlib.Path("/root/reference/app/SignalsmithStretch.mjs")
DRIVER = pathlib.Path(__file__).with_name("driver.mjs")


def _native():
    from golden_wasm import native

    return native


def available() -> bool:
    if REFERENCE.exists():
        try:
            if _native().available():
                return True
        except Exception:
            pass
    return shutil.which("node") is not None and REFERENCE.exists()


def render_reference(
    audio: np.ndarray,
    sample_rate: float,
    n_out: int,
    rate: float = 1.0,
    semitones: float = 0.0,
    tonality_hz: float = 8000.0,
    formant_semitones: float = 0.0,
    formant_compensation: bool = False,
    formant_base_hz: float = 0.0,
    block_ms: float = 120.0,
    interval_ms: float = 30.0,
    split_computation: bool = True,
) -> np.ndarray:
    """Render ``n_out`` samples through the reference WASM engine."""
    if not available():
        raise RuntimeError("no WASM execution path (gcc/node) available")
    try:
        native = _native()
        if native.available():
            return native.render_reference(
                audio, sample_rate, n_out, rate=rate, semitones=semitones,
                tonality_hz=tonality_hz, formant_semitones=formant_semitones,
                formant_compensation=formant_compensation,
                formant_base_hz=formant_base_hz, block_ms=block_ms,
                interval_ms=interval_ms, split_computation=split_computation,
            )
    except Exception:
        if shutil.which("node") is None:
            raise
    audio = np.ascontiguousarray(audio, np.float32)
    channels, frames = audio.shape
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        (td / "in.f32").write_bytes(audio.tobytes())
        cfg = {
            "reference": str(REFERENCE),
            "sampleRate": sample_rate,
            "channels": channels,
            "inputRaw": str(td / "in.f32"),
            "inputFrames": frames,
            "outputRaw": str(td / "out.f32"),
            "outputFrames": n_out,
            "configure": {
                "blockMs": block_ms,
                "intervalMs": interval_ms,
                "splitComputation": split_computation,
            },
            "schedule": {
                "active": True,
                "input": 0,
                "output": 0,
                "rate": rate,
                "semitones": semitones,
                "tonalityHz": tonality_hz,
                "formantSemitones": formant_semitones,
                "formantCompensation": formant_compensation,
                "formantBaseHz": formant_base_hz,
            },
        }
        (td / "cfg.json").write_text(json.dumps(cfg))
        subprocess.run(
            ["node", str(DRIVER), str(td / "cfg.json")],
            check=True, capture_output=True, text=True, timeout=600,
        )
        out = np.frombuffer((td / "out.f32").read_bytes(), np.float32)
    return out.reshape(channels, n_out).copy()


def compare(rate: float, semitones: float, seconds: float = 2.0) -> float:
    """Render both engines at matched settings; returns SNR in dB."""
    from bauklank.engine import StretchConfig, StretchParams, stretch_offline

    sr = 44100.0
    rng = np.random.default_rng(0)
    n = int(seconds * sr * max(rate, 1.0)) + int(sr)
    t = np.arange(n) / sr
    x = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)[None]
    n_out = int(seconds * sr)

    ref = render_reference(x, sr, n_out, rate=rate, semitones=semitones)
    cfg = StretchConfig(
        channels=1,
        block=round(0.12 * sr),
        interval=round(0.03 * sr),
        formants=False,
    )
    params = StretchParams.make(rate=rate, semitones=semitones, sample_rate=sr)
    got = stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    a = ref[:, cfg.block :]
    b = got[:, cfg.block :]
    return float(10 * np.log10(np.mean(a**2) / max(np.mean((a - b) ** 2), 1e-30)))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--semitones", type=float, default=0.0)
    args = ap.parse_args()
    print(f"SNR vs reference WASM: {compare(args.rate, args.semitones):.1f} dB")
