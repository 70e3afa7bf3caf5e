"""FFT-fast size selection for the fast engine.

``fast_fft_size(n)`` returns the smallest size >= n of the form
``2^a * k`` with ``k in {1, 3, 7, 9, 21}`` (FFT sizes whose odd part is
small).  The fast engine rounds its block size up to this grid — the same
move the reference's DSP core makes internally when it picks an FFT size at
or above the requested block.  The grid sets the fast engine's block, so
changing it changes that engine's output; the time of a grid size against
a non-grid one on the GPU is recorded in PERF.md.  (The fidelity engine's
FFT size is the blob's own, ``engine.spectral.fft_size_for``.)
"""

from __future__ import annotations

import functools

__all__ = ["fast_fft_size"]

_ODD_PARTS = (1, 3, 7, 9, 21)


@functools.lru_cache(maxsize=256)
def fast_fft_size(n: int) -> int:
    n = max(2, int(n))
    best = None
    for k in _ODD_PARTS:
        m = k
        while m < n:
            m *= 2
        if best is None or m < best:
            best = m
    return best
