"""ctypes bindings for the native runtime, with pure-Python fallbacks.

The native path (bauklank/runtime/wavio.cpp) is used when a toolchain
is available; otherwise WAV I/O falls back to the stdlib ``wave`` module
(PCM16 only) so the framework stays importable anywhere.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import wave

import numpy as np

from bauklank.runtime import build as _build

__all__ = [
    "native_available",
    "wav_read",
    "wav_write",
    "interleave",
    "deinterleave",
    "RingBuffer",
]


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("frames", ctypes.c_int64),
    ]


@functools.lru_cache(maxsize=1)
def _lib():
    path = _build.build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.bk_wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo),
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.bk_wav_read.restype = ctypes.c_int
    lib.bk_wav_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int32]
    lib.bk_wav_write.restype = ctypes.c_int
    lib.bk_free.argtypes = [ctypes.c_void_p]
    lib.bk_interleave.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int32, ctypes.c_int64]
    lib.bk_deinterleave.argtypes = list(lib.bk_interleave.argtypes)
    lib.bk_ring_create.argtypes = [ctypes.c_int64]
    lib.bk_ring_create.restype = ctypes.c_void_p
    lib.bk_ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("bk_ring_size", "bk_ring_space"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int64
    for name in ("bk_ring_push", "bk_ring_pop"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    return _lib() is not None


def wav_read(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (planes [channels, frames] float32, sample_rate)."""
    lib = _lib()
    path = str(path)
    if lib is not None:
        info = _WavInfo()
        data = ctypes.POINTER(ctypes.c_float)()
        rc = lib.bk_wav_read(path.encode(), ctypes.byref(info), ctypes.byref(data))
        if rc == 0:
            n = info.channels * info.frames
            arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
            lib.bk_free(ctypes.cast(data, ctypes.c_void_p))
            return arr.reshape(info.channels, info.frames), int(info.sample_rate)
        raise OSError(f"bk_wav_read({path}) failed with {rc}")
    # stdlib fallback: PCM16 only
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        if w.getsampwidth() != 2:
            raise OSError("python fallback supports 16-bit PCM only")
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    planes = raw.reshape(-1, ch).T.astype(np.float32) / 32768.0
    return planes, sr


def wav_write(path: str | pathlib.Path, planes: np.ndarray, sample_rate: int,
              as_float: bool = False) -> None:
    """Write deinterleaved planes [channels, frames] to a WAV file."""
    planes = np.ascontiguousarray(planes, np.float32)
    ch, frames = planes.shape
    lib = _lib()
    if lib is not None:
        rc = lib.bk_wav_write(
            str(path).encode(),
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ch, frames, int(sample_rate), int(as_float),
        )
        if rc != 0:
            raise OSError(f"bk_wav_write({path}) failed with {rc}")
        return
    with wave.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        pcm = (np.clip(planes.T, -1, 1) * 32767.0).round().astype(np.int16)
        w.writeframes(pcm.tobytes())


def interleave(planes: np.ndarray) -> np.ndarray:
    planes = np.ascontiguousarray(planes, np.float32)
    ch, frames = planes.shape
    lib = _lib()
    out = np.empty(ch * frames, np.float32)
    if lib is not None:
        lib.bk_interleave(
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ch, frames,
        )
        return out
    return planes.T.reshape(-1).copy()


def deinterleave(inter: np.ndarray, channels: int) -> np.ndarray:
    inter = np.ascontiguousarray(inter, np.float32)
    frames = inter.shape[0] // channels
    lib = _lib()
    out = np.empty((channels, frames), np.float32)
    if lib is not None:
        lib.bk_deinterleave(
            inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), channels, frames,
        )
        return out
    return inter.reshape(frames, channels).T.copy()


class RingBuffer:
    """Lock-free SPSC float ring (native); numpy deque fallback."""

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        lib = _lib()
        self._lib = lib
        if lib is not None:
            self._handle = lib.bk_ring_create(self.capacity)
        else:
            self._buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32).reshape(-1)
        if self._lib is not None:
            return int(self._lib.bk_ring_push(
                self._handle,
                samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                samples.shape[0],
            ))
        n = min(samples.shape[0], self.capacity - self._buf.shape[0])
        self._buf = np.concatenate([self._buf, samples[:n]])
        return int(n)

    def pop(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        if self._lib is not None:
            self._lib.bk_ring_pop(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
            )
            return out
        take = min(n, self._buf.shape[0])
        out[:take] = self._buf[:take]
        self._buf = self._buf[take:]
        return out

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.bk_ring_size(self._handle))
        return int(self._buf.shape[0])

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.bk_ring_destroy(self._handle)
            self._handle = None
