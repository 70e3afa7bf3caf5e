"""Native host runtime (C++ via ctypes): WAV codec, SPSC ring buffer."""

from bauklank.runtime.lib import (
    native_available,
    wav_read,
    wav_write,
    interleave,
    deinterleave,
    RingBuffer,
)

__all__ = [
    "native_available",
    "wav_read",
    "wav_write",
    "interleave",
    "deinterleave",
    "RingBuffer",
]
