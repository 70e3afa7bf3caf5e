"""Pallas kernel (Triton route): the blob's sequential per-band phase chain.

The fidelity engine's step 7 (docs/WASM-ALGO.md) finalizes band ``b`` from
band ``b-1`` and ``b-long_step`` — an irreducibly sequential chain over
thousands of bands, and each hop depends on the previous one.  The only
parallel axes are streams and channels, so the chain is bound by the
latency of one band's dependent arithmetic, not by FLOPs or bytes.  As a
vmapped ``lax.scan`` every band costs at least one kernel launch on a GPU;
here one program walks all bands of a hop in a loop:

- STREAMS ACROSS THREADS: a program owns ``TILE`` streams (one warp, one
  stream per thread); the stream axis is padded to the tile;
- the band loop runs inside the kernel; the last ``long_step`` finalized
  bands (per channel, re/im) ride the loop carry in registers — at
  ``long_step == 1`` (overlap-1 geometries, the kiosk point) the ring is a
  single row;
- planes are laid out ``[plane, B, S]``, so one band's loads are one
  coalesced row per plane;
- the loads of the next ``UNROLL`` bands do not depend on the chain: they
  are issued one chunk ahead and carried, so their latency hides behind
  the current chunk's dependent arithmetic.

Math (the same formulas as ``engine.spectral._band_chain_scan``):

    ph   = u[b] + 1{b>=1} out[mc, b-1]·d1[b] + 1{b>=L} out[mc, b-L]·d2[b]
    (|ph|^2 <= EPS -> ph = pi[b], |ph|^2 = |pi|^2 + EPS)
    out[mc, b] = sqrt(pe[b]/|ph|^2)·ph
    out[c, b]  = sqrt(pec[c,b]/|out_mc·lock[c,b]|^2)·(out_mc·lock[c,b])
                 (same EPS fallback with pic[c,b])

Rounding on the card: Triton lowers f32 ``/`` to the approximate
``div.full.f32`` and contracts mul+add into FMA.  The blob (WASM) rounds
every multiply, add, divide and square root separately, so the compiled
kernel issues ``mul.rn``/``div.rn``/``sqrt.rn`` through inline PTX, which
neither LLVM nor ptxas fuses.  ``|z|^2`` is ``re*re + im*im`` (the blob's
``std::norm``); the scan squares XLA's complex ``abs``, so the two differ
in the last bits (compared on the card by ``chip_smoke.py`` phase 6).

Layouts (S = streams padded to ``TILE``; B = bands; C = channels):
    lead [10, B, S] f32: d1.re, d1.im, d2.re, d2.im, u.re, u.im,
                         pi.re, pi.im, pe, mc      (leader-selected; mc as f32)
    chan [C, 5, B, S] f32: lock.re, lock.im, pec, pic.re, pic.im
    out  [C, 2, B, S] f32: out.re, out.im
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["band_chain", "TILE"]

EPS = 1e-15  # engine.spectral.EPS
TILE = 32    # streams per program: one warp, one stream per thread
UNROLL = 4   # bands per loaded chunk (the prefetch distance)
LEAD_PLANES = 10
CHAN_PLANES = 5


def _rn(op: str, *args, interpret: bool):
    """IEEE round-to-nearest ``op`` on f32 vectors, opaque to FMA contraction
    on the card; plain JAX arithmetic in interpret mode (XLA:CPU neither
    contracts nor approximates)."""
    if interpret:
        if op == "mul":
            return args[0] * args[1]
        if op == "div":
            return args[0] / args[1]
        return jnp.sqrt(args[0])
    operands = ", ".join(f"${i + 1}" for i in range(len(args)))
    (out,) = plgpu.elementwise_inline_asm(
        f"{op}.rn.f32 $0, {operands};",
        args=list(args),
        constraints="=f," + ",".join("f" * len(args)),
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(args[0].shape, jnp.float32)],
    )
    return out


def _kernel(c_n, long_step, b_n, interpret, lead_ref, chan_ref, out_ref):
    mul = functools.partial(_rn, "mul", interpret=interpret)
    div = functools.partial(_rn, "div", interpret=interpret)
    sqrt = functools.partial(_rn, "sqrt", interpret=interpret)

    def load_band(b):
        lead = tuple(lead_ref[k, b, :] for k in range(LEAD_PLANES))
        chan = tuple(
            tuple(chan_ref[c, k, b, :] for k in range(CHAN_PLANES))
            for c in range(c_n)
        )
        return lead, chan

    def leader(row, mc):
        """The leader channel's (re, im) of one ring row."""
        re, im = row[0]
        for c in range(1, c_n):
            sel = mc == c
            re = jnp.where(sel, row[c][0], re)
            im = jnp.where(sel, row[c][1], im)
        return re, im

    def band(b, ring, loaded):
        (d1r, d1i, d2r, d2i, ur, ui, pir, pii, pe, mc), chan = loaded
        zero = jnp.zeros_like(ur)
        # ring row L-1 = band b-1, row 0 = band b-long_step
        o1r, o1i = leader(ring[long_step - 1], mc)
        oLr, oLi = leader(ring[0], mc)
        t1r = mul(o1r, d1r) - mul(o1i, d1i)
        t1i = mul(o1r, d1i) + mul(o1i, d1r)
        tLr = mul(oLr, d2r) - mul(oLi, d2i)
        tLi = mul(oLr, d2i) + mul(oLi, d2r)
        phr = ur + jnp.where(b >= 1, t1r, zero)
        phi = ui + jnp.where(b >= 1, t1i, zero)
        phr = phr + jnp.where(b >= long_step, tLr, zero)
        phi = phi + jnp.where(b >= long_step, tLi, zero)
        p2 = mul(phr, phr) + mul(phi, phi)
        tiny = p2 <= EPS
        phr = jnp.where(tiny, pir, phr)
        phi = jnp.where(tiny, pii, phi)
        p2 = jnp.where(tiny, mul(pir, pir) + mul(pii, pii) + EPS, p2)
        s = sqrt(div(pe, p2))
        omr = mul(s, phr)
        omi = mul(s, phi)

        row = []
        for c in range(c_n):
            lr, li, pec, pcr, pci = chan[c]
            cr = mul(omr, lr) - mul(omi, li)
            ci = mul(omr, li) + mul(omi, lr)
            c2 = mul(cr, cr) + mul(ci, ci)
            tc = c2 <= EPS
            cr = jnp.where(tc, pcr, cr)
            ci = jnp.where(tc, pci, ci)
            c2 = jnp.where(tc, mul(pcr, pcr) + mul(pci, pci) + EPS, c2)
            sc = sqrt(div(pec, c2))
            is_lead = mc == c
            ocr = jnp.where(is_lead, omr, mul(sc, cr))
            oci = jnp.where(is_lead, omi, mul(sc, ci))
            out_ref[c, 0, b, :] = ocr
            out_ref[c, 1, b, :] = oci
            row.append((ocr, oci))
        # drop the oldest row, append band b (a renaming of registers)
        return ring[1:] + (tuple(row),)

    def load_chunk(i):
        return tuple(load_band(i * UNROLL + j) for j in range(UNROLL))

    def chunk(i, carry):
        ring, loaded = carry
        # issue the next chunk's loads before this chunk's dependent math
        # (the last chunk reloads itself: in bounds, and never used)
        nxt = load_chunk(jnp.minimum(i + 1, n_chunks - 1))
        for j in range(UNROLL):
            ring = band(i * UNROLL + j, ring, loaded[j])
        return ring, nxt

    zeros = jnp.zeros((lead_ref.shape[-1],), jnp.float32)
    ring = tuple(
        tuple((zeros, zeros) for _ in range(c_n)) for _ in range(long_step)
    )
    n_chunks = b_n // UNROLL
    if n_chunks:
        ring, _ = jax.lax.fori_loop(0, n_chunks, chunk, (ring, load_chunk(0)))
    if b_n % UNROLL:
        ring = jax.lax.fori_loop(
            n_chunks * UNROLL, b_n,
            lambda b, r: band(b, r, load_band(b)), ring)


@functools.partial(jax.jit, static_argnames=("long_step", "interpret"))
def band_chain(
    lead: jnp.ndarray,   # [10, B, S] f32
    chan: jnp.ndarray,   # [C, 5, B, S] f32
    *,
    long_step: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Run the chain; returns out [C, 2, B, S] f32 (re/im planes).

    S must be a multiple of ``TILE``.  ``interpret`` runs the kernel on the
    CPU through the Pallas interpreter (tests only)."""
    _, b_n, s_n = lead.shape
    c_n = chan.shape[0]
    if s_n % TILE:
        raise ValueError(f"streams {s_n} not a multiple of {TILE}")
    return pl.pallas_call(
        functools.partial(_kernel, c_n, long_step, b_n, interpret),
        grid=(s_n // TILE,),
        in_specs=[
            pl.BlockSpec((LEAD_PLANES, b_n, TILE), lambda s: (0, 0, s)),
            pl.BlockSpec((c_n, CHAN_PLANES, b_n, TILE), lambda s: (0, 0, 0, s)),
        ],
        out_specs=pl.BlockSpec((c_n, 2, b_n, TILE), lambda s: (0, 0, 0, s)),
        out_shape=jax.ShapeDtypeStruct((c_n, 2, b_n, s_n), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="band_chain",
    )(lead, chan)
