"""Modified real DFT: bands centered at (k + 1/2) bins.

The band grid deliberately places bin centers at ``f_k = (k + 0.5) / N``
(cycles/sample).  Compared with the standard rFFT grid this removes the DC
and Nyquist special cases, so a block of ``N`` real samples maps to exactly
``N/2`` structurally identical complex bands — the whole spectral pipeline
(map/rotate/formant) vectorizes with no edge cases.  It is also the natural grid for a pitch mapper: every band has a
well-defined nonzero center frequency.  (The reference engine exposes the
same banding through its opaque WASM core; our public surface only promises
``bins == block // 2`` and band centers at (k+0.5)/N.)

Forward:  X[k] = sum_n x[n] * exp(-2i*pi*(k+1/2)*n/N),  k in [0, N/2)
Inverse:  x[n] = (2/N) * Re( sum_k X[k] * exp(+2i*pi*(k+1/2)*n/N) )

Fast path (the default): decimation-in-time over even/odd samples packs the
real input into ONE complex FFT of size N/2 — half the FFT work of the
naive premodulate-then-size-N-FFT route.  With E[m] = x[2m], O[m] = x[2m+1]
and the half-bin transform T[f][k] = sum_m f[m] e^{-2i pi (k+1/2) m / M}
(M = N/2, conjugate-symmetric for real f: T[M-1-k] = conj(T[k])):

    X[k] = T[E][k] + w_k * T[O][k],      w_k = e^{-2i pi (k+1/2) / N}

T[E +iO] is computed with one premodulated size-M complex FFT and unpacked
through the symmetry.  The inverse runs the algebra backwards (exact).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "mdft",
    "imdft",
    "mdft_fused",
    "imdft_fused",
    "num_bands",
    "band_freqs",
]


def num_bands(block: int) -> int:
    return block // 2


def band_freqs(block: int) -> np.ndarray:
    """Band center frequencies in cycles/sample (numpy, host-side)."""
    return ((np.arange(block // 2) + 0.5) / block).astype(np.float32)


def _unit_phase(phase: np.ndarray) -> jnp.ndarray:
    """Complex exponential built on-device from a real numpy constant."""
    p = phase.astype(np.float32)
    return jax.lax.complex(jnp.cos(jnp.asarray(p)), jnp.sin(jnp.asarray(p))).astype(jnp.complex64)


def _halfbin_fwd(z: jnp.ndarray, m: int) -> jnp.ndarray:
    """T[z][k] = sum_m z[m] e^{-2i pi (k+1/2) m / M} via premod + FFT."""
    pre = _unit_phase(-np.pi * np.arange(m) / m)
    return jnp.fft.fft(z * pre, axis=-1)


def _halfbin_inv(spec: jnp.ndarray, m: int) -> jnp.ndarray:
    post = _unit_phase(np.pi * np.arange(m) / m)
    return jnp.fft.ifft(spec, axis=-1) * post


def mdft(x: jnp.ndarray) -> jnp.ndarray:
    """Forward modified real DFT over the last axis.

    x: real [..., N]  ->  complex64 [..., N/2]
    """
    n = x.shape[-1]
    m = n // 2
    x = x.astype(jnp.float32)
    even = x[..., 0::2]
    odd = x[..., 1::2]
    tz = _halfbin_fwd(jax.lax.complex(even, odd), m)  # [..., M]
    tz_rev = jnp.conj(tz[..., ::-1])
    te = 0.5 * (tz + tz_rev)
    to = -0.5j * (tz - tz_rev)
    w = _unit_phase(-2.0 * np.pi * (np.arange(m) + 0.5) / n)
    return (te + w * to).astype(jnp.complex64)


def imdft(spec: jnp.ndarray, block: int) -> jnp.ndarray:
    """Inverse modified real DFT over the last axis.

    spec: complex [..., N/2]  ->  real float32 [..., N]
    """
    half = spec.shape[-1]
    assert block == 2 * half, (block, half)
    m = half
    x_rev = jnp.conj(spec[..., ::-1])
    te = 0.5 * (spec + x_rev)
    w = _unit_phase(-2.0 * np.pi * (np.arange(m) + 0.5) / block)
    to = (spec - x_rev) * (0.5 / w)
    z = _halfbin_inv(te + 1j * to, m)
    even = jnp.real(z)
    odd = jnp.imag(z)
    out = jnp.stack([even, odd], axis=-1).reshape(spec.shape[:-1] + (block,))
    return out.astype(jnp.float32)


# ------------------------------------------------------- fused matmul MDFT
#
# The jnp.fft MDFT path surrounds the FFT
# with three elementwise HBM passes (premodulate, conjugate-symmetric
# unpack, center-phase multiply) over the full [rows, M] complex working
# set.  A two-stage Cooley-Tukey DFT written as matmuls can fold every
# one of those diagonal scalings into its constant stage matrices for free
# (zero extra FLOPs); whether the folded composite beats the jnp.fft
# composite is a measurement per device (off by default, engine.core).
#
# Factorization: M = P*Q with P the largest power-of-two divisor <= 128
# (every engine size sits on the 2^a*{1,3,7,9,21} grid, ops/fftsize.py, so
# M = 2688 -> 128*21, M = 512 -> 128*4, ...).  With m = Q*p + q and
# k = P*k2 + k1:
#
#   T[k] = FFT_M(z * pre)[k]
#        = sum_q e^{-2i pi q(P k2 + k1)/M} sum_p (z*pre)[Qp+q] W_P[p,k1]
#
# pre[m] = e^{-i pi m/M} separates as e^{-i pi p/P} * e^{-i pi q/M}: the p
# part folds into W_P's rows, the q part into the twiddle diagonal.  The
# unpack X[k] = a[k] T[k] + b[k] conj(T[M-1-k]) (a = (1 - i w)/2,
# b = (1 + i w)/2) is two diagonals plus an index reversal, which in the
# [k1, k2] layout is a flip of both axes — served by a second small
# stage-2 matmul on conj(B) with flipped constants.  The center phase
# i*(-1)^k and the synthesis window fold the same way.  Stage-2 einsums
# emit the [.., k2, k1] layout directly ('...kq,qj->...jk'), so the CT
# output permutation costs no explicit transpose pass.
#
# These are NEW functions: engine.spectral/fidelity must stay hop-exact vs
# the blob oracle (CLAUDE.md invariants), so mdft()/imdft() above are
# untouched and only the fast engine may opt in.


def _ct_factors(m: int) -> tuple[int, int]:
    p = 1
    while m % (p * 2) == 0 and p < 128:
        p *= 2
    return p, m // p


@functools.lru_cache(maxsize=None)
def _fused_fwd_consts(n: int, center_phase: bool):
    """Host-side real/imag parts of the forward stage constants (complex
    arrays cannot cross host->device on some attachment paths)."""
    m = n // 2
    p, q = _ct_factors(m)
    pp = np.arange(p)[:, None]
    k1 = np.arange(p)[None, :]
    qq = np.arange(q)
    # W1[p_, k1] = e^{-i pi p_/P} e^{-2i pi p_ k1/P}
    w1 = np.exp(-1j * np.pi * pp / p - 2j * np.pi * pp * k1 / p)
    # tw[k1, q_] = e^{-i pi q_/M} e^{-2i pi q_ k1/M}
    tw = np.exp(-1j * np.pi * qq[None, :] / m - 2j * np.pi * qq[None, :] * k1.T / m)
    # WQ[q_, k2] = e^{-2i pi q_ k2/Q}
    wq = np.exp(-2j * np.pi * qq[:, None] * np.arange(q)[None, :] / q)
    # unpack diagonals in the [k2, k1] output layout
    k = (np.arange(q)[:, None] * p + np.arange(p)[None, :]).astype(np.float64)
    w = np.exp(-2j * np.pi * (k + 0.5) / n)
    a = 0.5 * (1.0 - 1j * w)
    b = 0.5 * (1.0 + 1j * w)
    if center_phase:
        c = 1j * np.where(k.astype(np.int64) % 2 == 0, 1.0, -1.0)
        a = a * c
        b = b * c
    out = (w1, tw, wq, a, b)
    return tuple(
        (z.real.astype(np.float32), z.imag.astype(np.float32)) for z in out
    )


def _dev_cx(ri) -> jnp.ndarray:
    return jax.lax.complex(jnp.asarray(ri[0]), jnp.asarray(ri[1]))


def mdft_fused(
    x: jnp.ndarray,
    center_phase: bool = False,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Forward MDFT as two folded matmul stages.

    Numerically equivalent to ``mdft(x)`` (times ``i*(-1)^k`` when
    ``center_phase``) to float32 roundoff — NOT bit-identical; the
    blob-exact engine must keep :func:`mdft`.
    """
    n = x.shape[-1]
    m = n // 2
    p, q = _ct_factors(m)
    if q > 64 or p < 8:
        from bauklank.engine.core import _center_phase  # lazy, rare

        out = mdft(x)
        return out * _center_phase(m) if center_phase else out
    w1, tw, wq, a, b = map(_dev_cx, _fused_fwd_consts(n, bool(center_phase)))
    xf = x.astype(jnp.float32)
    z = jax.lax.complex(xf[..., 0::2], xf[..., 1::2])  # [.., M]
    zz = z.reshape(z.shape[:-1] + (p, q))
    aa = jnp.einsum("...pq,pk->...kq", zz, w1, precision=precision)
    bb = aa * tw  # tw is [k1, q]; broadcasts over the batch dims
    t = jnp.einsum("...kq,qj->...jk", bb, wq, precision=precision)
    bc = jnp.conj(bb)[..., ::-1, :]
    tr = jnp.einsum(
        "...kq,qj->...jk", bc, jnp.conj(wq)[:, ::-1], precision=precision
    )
    x2 = a * t + b * tr  # [.., k2, k1]
    return x2.reshape(x.shape[:-1] + (m,)).astype(jnp.complex64)


@functools.lru_cache(maxsize=None)
def _fused_inv_consts(n: int, center_phase_conj: bool):
    m = n // 2
    p, q = _ct_factors(m)
    k = np.arange(m).astype(np.float64)
    w = np.exp(-2j * np.pi * (k + 0.5) / n)
    # z2[k] = pc[k]*spec[k] + qc[k]*conj(spec[M-1-k])
    pc = 0.5 * (1.0 + 1j / w)
    qc = 0.5 * (1.0 - 1j / w)
    if center_phase_conj:
        # fold spec' = spec * conj(c), c[k] = i*(-1)^k:
        # pc' = pc*conj(c)[k]; the reversed term reads conj(spec*conj(c))[rev]
        # = conj(spec)[rev] * c[M-1-k], so qc' = qc*c[M-1-k].
        c = 1j * np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
        pc = pc * np.conj(c)
        qc = qc * c[::-1]
    k2 = np.arange(q)[:, None]
    qq = np.arange(q)[None, :]
    # VQ[k2, q_] = e^{+2i pi k2 q_/Q}
    vq = np.exp(2j * np.pi * k2 * qq / q)
    k1 = np.arange(p)
    # tdiag[q_, k1] = e^{+2i pi k1 q_/M} e^{+i pi q_/M}
    td = np.exp(2j * np.pi * k1[None, :] * np.arange(q)[:, None] / m
                + 1j * np.pi * np.arange(q)[:, None] / m)
    # VP[k1, p_] = (1/M) e^{+2i pi k1 p_/P} e^{+i pi p_/P}
    pp = np.arange(p)[None, :]
    vp = np.exp(2j * np.pi * k1[:, None] * pp / p + 1j * np.pi * pp / p) / m
    out = (pc, qc, vq, td, vp)
    return tuple(
        (z.real.astype(np.float32), z.imag.astype(np.float32)) for z in out
    )


def imdft_fused(
    spec: jnp.ndarray,
    block: int,
    window: jnp.ndarray | None = None,
    center_phase_conj: bool = False,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Inverse MDFT as two folded matmul stages.

    Equivalent to ``imdft(spec * conj(center_phase), block) * window`` with
    the diagonals folded into the stage constants (float32 roundoff).
    """
    m = spec.shape[-1]
    assert block == 2 * m, (block, m)
    p, q = _ct_factors(m)
    if q > 64 or p < 8:
        if center_phase_conj:
            from bauklank.engine.core import _center_phase

            spec = spec * jnp.conj(_center_phase(m))
        out = imdft(spec, block)
        return out * window if window is not None else out
    pc, qc, vq, td, vp = map(
        _dev_cx, _fused_inv_consts(block, bool(center_phase_conj))
    )
    z2 = pc * spec + qc * jnp.conj(spec[..., ::-1])
    zz = z2.reshape(z2.shape[:-1] + (q, p))  # [k2, k1]
    cc = jnp.einsum("...ab,aq->...qb", zz, vq, precision=precision)
    dd = cc * td  # td is [q_, k1]; broadcasts over the batch dims
    zm = jnp.einsum("...qb,bp->...pq", dd, vp, precision=precision)
    zf = zm.reshape(spec.shape[:-1] + (m,))
    out = jnp.stack([jnp.real(zf), jnp.imag(zf)], axis=-1).reshape(
        spec.shape[:-1] + (block,)
    )
    if window is not None:
        out = out * window
    return out.astype(jnp.float32)


# ---------------------------------------------------------------- reference
def _mdft_direct(x: jnp.ndarray) -> jnp.ndarray:
    """Naive premod + size-N complex FFT (kept as the test oracle)."""
    n = x.shape[-1]
    pre = _unit_phase(-np.pi * np.arange(n) / n)
    y = x.astype(jnp.float32) * pre
    return jnp.fft.fft(y, axis=-1)[..., : n // 2].astype(jnp.complex64)


def _imdft_direct(spec: jnp.ndarray, block: int) -> jnp.ndarray:
    half = spec.shape[-1]
    assert block == 2 * half
    z = jnp.concatenate(
        [spec, jnp.zeros(spec.shape[:-1] + (block - half,), spec.dtype)], axis=-1
    )
    post = _unit_phase(np.pi * np.arange(block) / block)
    t = jnp.fft.ifft(z, axis=-1) * post
    return (2.0 * jnp.real(t)).astype(jnp.float32)