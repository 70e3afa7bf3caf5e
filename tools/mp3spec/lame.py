"""Test-side mp3 oracle plumbing: encode via libmp3lame, decode via the
sandbox's libmpg123 (through pygame/SDL_mixer).

Neither library is a product dependency — ``bauklank.runtime.mp3``
is the product decoder.  These helpers exist so the test suite can
score it against an independent conforming decoder on material it
encodes on the fly (every MPEG version / channel mode), and so
``make_mp3_fixture.py`` can mint the committed fixture.

Reference parity: the reference kiosk's default content is mp3 decoded
by the browser (reference app/multi/app.mjs:10-22, 365-395).
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

__all__ = ["lame_available", "oracle_available", "lame_encode",
           "oracle_decode", "tonal_material"]


def lame_available() -> bool:
    try:
        ctypes.CDLL("libmp3lame.so.0")
        return True
    except OSError:
        return False


def oracle_available() -> bool:
    try:
        import pygame  # noqa: F401
        return True
    except ImportError:
        return False


def lame_encode(pcm: np.ndarray, sr: int, bitrate: int = 128,
                mode: int | None = None, vbr: bool = False) -> bytes:
    """Encode ``pcm [channels, n] float32`` to an mp3 stream.

    ``mode``: 0 stereo, 1 joint stereo, 3 mono (lame MPEG_mode).
    """
    L = ctypes.CDLL("libmp3lame.so.0")
    L.lame_init.restype = ctypes.c_void_p
    g = ctypes.c_void_p(L.lame_init())
    ch = pcm.shape[0]
    L.lame_set_in_samplerate(g, sr)
    L.lame_set_out_samplerate(g, sr)
    L.lame_set_num_channels(g, ch)
    if vbr:
        L.lame_set_VBR(g, 4)          # vbr_default (mtrh)
        L.lame_set_VBR_q(g, 2)
    else:
        L.lame_set_brate(g, bitrate)
    if mode is not None:
        L.lame_set_mode(g, mode)
    L.lame_set_bWriteVbrTag(g, 1 if vbr else 0)
    assert L.lame_init_params(g) >= 0
    n = pcm.shape[1]
    left = np.ascontiguousarray(pcm[0], np.float32)
    right = np.ascontiguousarray(pcm[ch - 1], np.float32)
    buf = ctypes.create_string_buffer(int(1.25 * n) + 14400)
    m = L.lame_encode_buffer_ieee_float(
        g, left.ctypes.data_as(ctypes.c_void_p),
        right.ctypes.data_as(ctypes.c_void_p), n, buf, len(buf))
    assert m >= 0, f"lame_encode_buffer failed: {m}"
    out = bytes(buf[:m])
    m2 = L.lame_encode_flush(g, buf, len(buf))
    out += bytes(buf[:m2])
    if vbr:
        # overwrite the placeholder Xing frame with the real one
        m3 = L.lame_get_lametag_frame(g, buf, len(buf))
        if 0 < m3 <= len(out):
            out = bytes(buf[:m3]) + out[m3:]
    L.lame_close(g)
    return out


def oracle_decode(mp3_bytes: bytes, sr: int, channels: int) -> np.ndarray:
    """Decode via SDL_mixer's bundled libmpg123 -> [channels, n] float32.

    Requires no audio hardware (SDL_AUDIODRIVER=dummy is set here)."""
    import os

    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame
    import pygame.sndarray as sndarray

    pygame.mixer.init(frequency=sr, size=-16, channels=channels)
    try:
        snd = pygame.mixer.Sound(io.BytesIO(mp3_bytes))
        arr = np.asarray(sndarray.array(snd), np.float32) / 32768.0
    finally:
        pygame.mixer.quit()
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr.T.copy()


def tonal_material(sr: int, n: int, channels: int, seed: int = 0) -> np.ndarray:
    """Deterministic AM'd multi-tone material (one timbre per channel)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.zeros((channels, n), np.float32)
    for c in range(channels):
        for f, a in ((220.0 * (c + 1), 0.3), (523.25, 0.2), (1870.0, 0.1),
                     (97.0, 0.15)):
            if f < sr / 2 * 0.95:
                x[c] += a * np.sin(2 * np.pi * f * t
                                   + rng.random() * 6).astype(np.float32)
        x[c] *= (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t + c)).astype(np.float32)
    return np.clip(x, -0.99, 0.99)
