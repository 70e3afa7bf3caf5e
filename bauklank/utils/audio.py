"""Track loading/saving for the data path.

The reference decodes mp3 via the browser's ``decodeAudioData``
(app/multi/app.mjs:365-395).  Headless equivalents here: WAV through the
native runtime codec, mp3 through the from-spec decoder in
``bauklank.runtime.mp3`` (validated >=60 dB vs libmpg123,
tests/test_mp3.py), anything else through ffmpeg when present (gated —
this image has none), with clear errors otherwise.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

from bauklank.runtime import wav_read, wav_write

__all__ = ["load_audio", "save_audio", "ffmpeg_available"]


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str | pathlib.Path, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Load an audio file -> (planes [channels, frames] float32, sr).

    WAV is decoded natively; other containers require ffmpeg.  When
    ``sample_rate`` is given and differs, the track is resampled (cubic
    Lagrange, bauklank.ops.resample).
    """
    path = pathlib.Path(path)
    if path.suffix.lower() == ".wav":
        planes, sr = wav_read(path)
    elif path.suffix.lower() == ".mp3":
        # native from-spec decoder (runtime/mp3.py) — the reference's
        # default content format (app/multi/app.mjs:10-22)
        from bauklank.runtime.mp3 import decode_mp3

        planes, sr = decode_mp3(path.read_bytes())
    else:
        if not ffmpeg_available():
            raise OSError(
                f"cannot decode {path.suffix}: ffmpeg not available; provide WAV"
            )
        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-i", str(path), tmp.name],
                check=True,
            )
            planes, sr = wav_read(tmp.name)
    if sample_rate is not None and sr != sample_rate:
        import jax.numpy as jnp

        from bauklank.ops.resample import resample

        ratio = sr / sample_rate
        out_len = int(planes.shape[1] / ratio)
        planes = np.asarray(resample(jnp.asarray(planes), jnp.float32(ratio), out_len))
        sr = sample_rate
    return planes, sr


def save_audio(path: str | pathlib.Path, planes: np.ndarray, sample_rate: int,
               as_float: bool = False) -> None:
    wav_write(path, planes, sample_rate, as_float=as_float)
