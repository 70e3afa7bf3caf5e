"""Exact fractional row gather as one-hot block matmuls.

The fidelity engine's hot loop reads spectra at per-(hop, stream) fractional
band positions (`engine.spectral._get_fractional`).  A per-row XLA gather
moves one tiny row (~16 B) per lookup.  The positions are NOT monotone in the
kiosk regime (the blob's MINSTD vertical steps scatter them by up to
±timeFactor bands), so the fast engine's banded-interpolation matmuls
(ops/pitchmap) do not apply.

This module reformulates the gather exactly, with no gather/scatter ops:

1. the band axis is cut into ``nblk = B/t`` blocks; an overlapped copy
   ``arr_over[j] = arr[j*t : j*t + 2t]`` makes both taps of any linear
   interpolation land inside one block;
2. a one-hot [K, nblk] block-selection matrix (iota compare) times
   ``arr_over`` fetches each output row's 2t-wide candidate window — a
   dense matmul instead of K tiny gathers (0/1 weights copy f32 values
   exactly under HIGHEST precision);
3. the two taps are selected in-register by an iota==offset compare and
   combined with the interpolation weights, reproducing
   ``_get_fractional``'s zero-outside-[0,B) semantics term for term.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = ["block_gather", "block_gather_complex"]


def block_gather(
    arrs: jnp.ndarray,  # [N, B, P] float32
    pos: jnp.ndarray,   # [N, K] float32
    t: int = 32,
    chunk: int = 16,
    mode: str = "highest",
    return_taps: bool = False,
    int_pos: bool = False,
    layout: str | None = None,
) -> jnp.ndarray:
    """Linear interpolation ``arrs[n, pos[n, k], p]`` with zeros outside
    [0, B) — exact `_get_fractional` semantics.  Returns [N, K, P], or
    with ``return_taps`` the uncombined ``(ga, gb, w0, w1)`` so a caller
    whose call site sits inside a compiled region (e.g. a lax.cond
    branch) can run the weighted combine at ITS top level — inside
    cond/map bodies XLA FMA-contracts the mul+add and breaks the
    bit-exact `_get_fractional` contract (see taps_chunk).

    ``t``: block granularity (B must divide by t).
    ``chunk``: examples per matmul batch (bounds the one-hot transient).
    ``mode``: how the stage-1 selection matmul guarantees an exact copy:
      - ``highest``: f32 einsum at HIGHEST precision (full f32 on the
        GPU; exact, as the one-hot row has a single nonzero term);
      - ``bf16x3``: 3 DEFAULT bf16 passes over an exact 3-way bf16 split
        of the payload (h1+h2+h3 == x in f32; exact for |x| >= ~2^-100
        and 0 — the 3rd residual underflows bf16 below that);
      - ``int8x4``: 4 int8->int32 passes selecting the raw f32 BIT
        pattern (4 byte planes, reassembled by shifts) — exact for every
        value including denormals/inf/nan.
    Selection sums have exactly one nonzero term per output row, which is
    what makes the split modes exact under any accumulation order
    (tests/test_blockgather.py pins bit-identity).

    ``int_pos``: assert-free promise that every position is an exact
    integer (the peaks map's boundary and rank lookups).  Then frac == 0
    makes the upper-tap weight identically zero, so the second tap mask
    and masked sum are skipped entirely — the combined result
    ``ga * ok0`` is bit-identical to the general path (ga*1 + gb*0).
    Incompatible with ``return_taps``.

    ``layout``: minor-axis layout of the chunk-body tensors (None -> the
    ``BAUKLANK_BGLAYOUT`` env var).  ``kmaj`` is the original form: tap
    masks [c, K, 2t] and rows [c, K, 2t, P] keep 2t (16 at t=8) or P
    (2-4) on the minor axis.
    ``kmin`` emits rows from the selection einsum as [c, 2t*P, K] and
    builds masks as [c, 2t, K] so the K axis (thousands) stays minor
    through every mask/masked-sum.  Identical 0/1 selection math either
    way.  ``kmaj`` stays the default; flip per-callsite only with an
    end-to-end measurement on the card."""
    if layout is None:
        layout = os.environ.get("BAUKLANK_BGLAYOUT", "kmaj")
    if mode != "highest":
        layout = "kmaj"  # the split modes' plane reassembly is K-major
    n, b, p = arrs.shape
    k = pos.shape[1]
    assert b % t == 0, (b, t)
    nblk = b // t

    # overlapped blocks: arr_over[n, j] = arr[n, j*t : j*t + 2t]
    padded = jnp.pad(arrs, ((0, 0), (0, t), (0, 0)))
    a0 = arrs.reshape(n, nblk, t, p)
    a1 = padded[:, t:].reshape(n, nblk, t, p)
    arr_over = jnp.concatenate([a0, a1], axis=2).reshape(n, nblk, 2 * t * p)
    if mode == "int8x4":
        i32 = jax.lax.bitcast_convert_type(arr_over, jnp.int32)
        arr_over = jnp.stack(
            [(i32 >> (8 * i)) & 255 for i in range(4)], axis=-1
        ).astype(jnp.int8).reshape(n, nblk, 2 * t * p * 4)

    i0 = jnp.floor(pos).astype(jnp.int32)              # [N, K]
    frac = (pos - i0).astype(jnp.float32)
    ok0 = ((i0 >= 0) & (i0 < b)).astype(jnp.float32)
    ok1 = ((i0 + 1 >= 0) & (i0 + 1 < b)).astype(jnp.float32)
    blk = jnp.clip(i0, 0, b - 1) // t                  # [N, K]
    off = i0 - blk * t                                 # [-inf, 2t) effective
    w0 = ok0 * (1.0 - frac)                            # [N, K]
    w1 = ok1 * frac

    # the [*, K, nblk] one-hot and [*, K, 2t] tap masks are built INSIDE
    # the chunked map: materialized for all N at once they dominate device
    # memory (4.7 GB at the serving shape S=64 H=8 B=2688)
    def _select_rows(blk_c, arr_o):
        """stage 1: one-hot block selection -> f32 rows [c, K, 2t, P]."""
        c = blk_c.shape[0]
        if mode == "bf16x3":
            oh = (blk_c[..., None] == jnp.arange(nblk)).astype(jnp.bfloat16)
            h1 = arr_o.astype(jnp.bfloat16)
            r1 = arr_o - h1.astype(jnp.float32)
            h2 = r1.astype(jnp.bfloat16)
            h3 = (r1 - h2.astype(jnp.float32)).astype(jnp.bfloat16)
            parts = [
                # bf16 x bf16 at DEFAULT (tensor cores, f32 accumulate):
                # one nonzero term per row, so each part copies exactly
                jnp.einsum("nkj,njr->nkr", oh, hh,
                           precision=jax.lax.Precision.DEFAULT,
                           preferred_element_type=jnp.float32)
                for hh in (h1, h2, h3)
            ]
            rows = (parts[0] + parts[1]) + parts[2]
        elif mode == "int8x4":
            oh = (blk_c[..., None] == jnp.arange(nblk)).astype(jnp.int8)
            planes = jnp.einsum(
                "nkj,njr->nkr", oh, arr_o, precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.int32,
            ).reshape(c, k, 2 * t * p, 4)          # int8 x int8 -> int32: exact
            bits = (
                (planes[..., 0] & 255)
                | ((planes[..., 1] & 255) << 8)
                | ((planes[..., 2] & 255) << 16)
                | ((planes[..., 3] & 255) << 24)
            )
            rows = jax.lax.bitcast_convert_type(bits, jnp.float32)
        else:
            oh = (blk_c[..., None] == jnp.arange(nblk)).astype(jnp.float32)
            rows = jnp.einsum(
                "nkj,njr->nkr", oh, arr_o,
                precision=jax.lax.Precision.HIGHEST,
            )                                          # [c, K, 2t*P]
        return rows.reshape(c, k, 2 * t, p)

    def taps_chunk(args):
        """PURE 0/1 tap selection -> ([c, K, P] lower, [c, K, P] upper).

        No interpolation weight touches the chunk body: XLA strips
        optimization_barriers from lax.map bodies and FMA-contracts any
        in-loop mul+add (measured ~1-ulp drift vs `_get_fractional` on
        CPU), so the body only does exact copies (every product is 0 or
        the value itself, under any dot/FMA lowering) and the rounding
        ops happen ONCE at top level, structurally identical to
        `_get_fractional`'s combine."""
        blk_c, off_c, arr_o = args
        oto = jnp.arange(2 * t, dtype=jnp.int32)
        if layout == "kmin":
            c = blk_c.shape[0]
            oh = (blk_c[..., None] == jnp.arange(nblk)).astype(jnp.float32)
            rows_t = jnp.einsum(
                "nkj,njr->nrk", oh, arr_o,
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(c, 2 * t, p, k)                  # [c, 2t, P, K]
            m0 = (oto[None, :, None] == off_c[:, None, :]).astype(
                jnp.float32)                           # [c, 2t, K]
            ga = jnp.moveaxis(
                jnp.sum(rows_t * m0[:, :, None, :], axis=1), 1, 2)
            if int_pos:
                return (ga,)
            m1 = (oto[None, :, None] == (off_c + 1)[:, None, :]).astype(
                jnp.float32)
            gb = jnp.moveaxis(
                jnp.sum(rows_t * m1[:, :, None, :], axis=1), 1, 2)
            return ga, gb
        rows = _select_rows(blk_c, arr_o)
        m0 = (oto == off_c[..., None]).astype(jnp.float32)
        ga = jnp.sum(rows * m0[..., None], axis=2)     # [c, K, P] copies
        if int_pos:
            return (ga,)
        m1 = (oto == (off_c + 1)[..., None]).astype(jnp.float32)
        gb = jnp.sum(rows * m1[..., None], axis=2)
        return ga, gb

    if n > chunk:
        # pad N up to a chunk multiple (zero rows, zero weights): chunking
        # must never silently disable — the full one-hot/tap transients for
        # all N at once are the documented multi-GB OOM hazard (ADVICE r3)
        pad_n = (-n) % chunk
        def padn(x):
            return jnp.pad(x, ((0, pad_n),) + ((0, 0),) * (x.ndim - 1))
        blk_p, off_p, arr_p = map(padn, (blk, off, arr_over))
        shape = ((n + pad_n) // chunk, chunk)
        taps = jax.lax.map(
            taps_chunk,
            (
                blk_p.reshape(shape + (k,)),
                off_p.reshape(shape + (k,)),
                arr_p.reshape(shape + (nblk, arr_over.shape[-1])),
            ),
        )
        taps = [x.reshape(n + pad_n, k, p)[:n] for x in taps]
    else:
        taps = list(taps_chunk((blk, off, arr_over)))
    ga, gb = (taps[0], None) if int_pos else taps
    if return_taps:
        assert not int_pos
        return ga, gb, w0, w1
    if int_pos:
        return ga * w0[..., None]      # w1 = ok1*frac == 0 identically
    return ga * w0[..., None] + gb * w1[..., None]


def block_gather_complex(
    arrs: jnp.ndarray,  # [N, B] complex64 (or [N, B, P] pre-split planes)
    pos: jnp.ndarray,   # [N, K]
    t: int = 32,
    chunk: int = 16,
) -> jnp.ndarray:
    """Complex wrapper: gathers re/im planes together, returns [N, K]."""
    planes = jnp.stack([jnp.real(arrs), jnp.imag(arrs)], axis=-1)
    out = block_gather(planes, pos, t=t, chunk=chunk)
    return jax.lax.complex(out[..., 0], out[..., 1])
