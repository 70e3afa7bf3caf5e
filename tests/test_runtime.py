"""Native runtime: WAV codec round-trips, interleave, ring buffer, CLI."""

import subprocess
import sys

import numpy as np
import pytest

from bauklank.runtime import (
    RingBuffer,
    deinterleave,
    interleave,
    native_available,
    wav_read,
    wav_write,
)
from tests.util import REPO_ROOT


def test_native_library_builds():
    assert native_available(), "g++ toolchain present in this image; must build"


def test_wav_roundtrip_pcm16(tmp_path):
    rng = np.random.default_rng(0)
    planes = np.clip(rng.standard_normal((2, 5000)) * 0.3, -0.99, 0.99).astype(np.float32)
    p = tmp_path / "t.wav"
    wav_write(p, planes, 44100)
    back, sr = wav_read(p)
    assert sr == 44100 and back.shape == (2, 5000)
    # quantization (0.5 LSB) + 32767-vs-32768 scale mismatch at |x|<=1
    assert np.max(np.abs(back - planes)) < 5e-5


def test_wav_roundtrip_float32(tmp_path):
    rng = np.random.default_rng(1)
    planes = rng.standard_normal((1, 3333)).astype(np.float32)
    p = tmp_path / "f.wav"
    wav_write(p, planes, 48000, as_float=True)
    back, sr = wav_read(p)
    assert sr == 48000
    np.testing.assert_array_equal(back, planes)


def test_wav_read_matches_stdlib(tmp_path):
    import wave

    rng = np.random.default_rng(2)
    pcm = (rng.standard_normal((100, 2)) * 10000).astype(np.int16)
    p = tmp_path / "s.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    planes, sr = wav_read(p)
    assert sr == 22050
    np.testing.assert_allclose(planes, pcm.T.astype(np.float32) / 32768.0, atol=1e-7)


def test_interleave_roundtrip():
    rng = np.random.default_rng(3)
    planes = rng.standard_normal((2, 777)).astype(np.float32)
    inter = interleave(planes)
    assert inter.shape == (1554,)
    assert inter[0] == planes[0, 0] and inter[1] == planes[1, 0]
    back = deinterleave(inter, 2)
    np.testing.assert_array_equal(back, planes)


def test_ring_buffer_spsc():
    r = RingBuffer(1024)
    assert len(r) == 0
    n = r.push(np.arange(100, dtype=np.float32))
    assert n == 100 and len(r) == 100
    out = r.pop(40)
    np.testing.assert_array_equal(out, np.arange(40, dtype=np.float32))
    assert len(r) == 60
    # underflow zero-fills
    out = r.pop(100)
    np.testing.assert_array_equal(out[:60], np.arange(40, 100, dtype=np.float32))
    np.testing.assert_array_equal(out[60:], 0.0)
    # overflow truncates
    big = np.ones(2000, np.float32)
    n = r.push(big)
    assert n == 1024


def test_cli_stretch_end_to_end(tmp_path):
    sr = 44100
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    wav_write(tmp_path / "in.wav", x[None, :], sr)
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin",
           "PYTHONPATH": str(REPO_ROOT)}
    res = subprocess.run(
        [sys.executable, "-m", "bauklank", "stretch",
         str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
         "--rate", "0.5", "--semitones", "12", "--block-ms", "40"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    out, sr2 = wav_read(tmp_path / "out.wav")
    assert sr2 == sr and out.shape[1] == 2 * sr
    from tests.util import dominant_freq

    seg = out[0, 6000:14192]
    assert abs(dominant_freq(seg, sr) - 880.0) < 6.0


def test_load_audio_resamples(tmp_path):
    from tests.util import dominant_freq, tone

    from bauklank.utils.audio import load_audio

    sr_in = 22050
    x = tone(1000.0, 2 * sr_in, sr_in)
    wav_write(tmp_path / "r.wav", x[None, :], sr_in)
    planes, sr = load_audio(tmp_path / "r.wav", sample_rate=44100)
    assert sr == 44100
    assert abs(planes.shape[1] - 2 * 44100) <= 4
    assert abs(dominant_freq(planes[0, 1000:9192], 44100.0) - 1000.0) < 5.0


def test_cli_topology_header():
    res = subprocess.run(
        [sys.executable, "-m", "bauklank", "topology-header"],
        capture_output=True, text=True, timeout=120,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(REPO_ROOT)},
    )
    assert res.returncode == 0
    assert "TIME_PITCH_TOPOLOGY" in res.stdout
