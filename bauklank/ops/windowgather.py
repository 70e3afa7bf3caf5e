"""Shared-window six-family gather in pure XLA (batched one-hot einsums).

In the deterministic time-step regime (every stream at timeFactor <= 2,
i.e. rate >= 0.5 — the whole BASELINE matrix) the blob's vertical steps
are the scalar clamp(tf, 0.5, 2), so the six chain-input gather families
(`engine.spectral._hop_inputs_hoisted`) all read within a 2L+1-band
window of input_bin[k]:

    pred    @ input_bin[k]
    down_s  @ input_bin[k] - c            (c in [0.5, 2])
    down_l  @ input_bin[k] - L*c
    us      @ input_bin[k+1] - c          (the next band's window)
    ul      @ input_bin[k+L] - L*c
    comb    @ input_bin[k]                (prev_rot + energy planes)

The generic path (`ops.blockgather`) runs one one-hot selection PER
position: ~52*B^2 selection MACs.  Here ONE window selection per output
band serves every family: a [B, nhi] block one-hot times the overlapped
window payload fetches each band's 2*t1-wide candidate strip for ALL 10
payload planes in one batched einsum (20*B^2 MACs, 2.6x fewer), and the
per-family taps are pure 0/1 selections inside that strip.

Exactness (the repo's maxdiff==0 contract vs `_get_fractional`):

- the selection einsum is one-hot x f32 at HIGHEST precision — exact
  row copies (each output sums exactly one nonzero product);
- tap selection is PURE 0/1 (every product is 0 or a copy, exact under
  any dot/FMA lowering) and runs inside the lax.map chunk body; the
  interpolation-weighted combine happens ONCE at the caller's top level
  (the chunked-gather FMA hazard, ops/blockgather.py taps_chunk);
- in this regime the six families need only THREE tap selections:
  pred and comb share the input_bin position (one selection over all 10
  payload planes), and us/ul taps are exact lane shifts of down_s /
  down_l taps (us_pos[k] = input_bin[k+1] - c = the down_s position at
  band k+1, since the step is the same scalar for every band; weights
  shift identically, being functions of the same float positions).  The
  last ``shift`` lanes have no k+shift source — there the only
  possibly-valid tap is band 0 (upper tap of a position in (-1, 0)),
  patched directly (tail_fix).

Reference parity: the gathers this fuses are the blob's getFractional
calls in steps 6-7 (reference app/SignalsmithStretch.mjs:826-954);
semantics pinned by tests/test_windowgather.py (bit-identity vs
`ops.blockgather.block_gather` after the weighted combine) and the
tests/test_spectral.py hoisted-vs-local maxdiff==0 micro-check.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = ["window_gather_taps", "window_t1"]


def window_t1(bands: int, long_step: int) -> int | None:
    """Smallest block size t1 with bands % t1 == 0 whose 2*t1 window
    covers the family span (anchor = floor(input_bin - L*c) with
    c <= 2: the furthest tap is floor(input_bin)+1 <= anchor + 2L+2,
    so t1 >= 2L+3 suffices).  Smaller t1 = narrower tap masks at
    the same total einsum MACs; None if the band grid can't host one."""
    span = 2 * long_step + 3
    for t1 in (16, 24, 32, 48, 64, 96, 128):
        if t1 >= span and bands % t1 == 0 and bands // t1 >= 8:
            return t1
    return None


def window_geom(bands: int, long_step: int, t1: int) -> tuple[int, int]:
    """Default (g, w): finest block stride g dividing the band grid with
    the minimal covering strip w = g + 2L + 2.  The tap masked-sums cost
    ~linearly in w while the one-hot einsum MACs scale in w/g."""
    for g in (8, 16, 24, 32):
        if bands % g == 0 and bands // g >= 8:
            return g, g + 2 * long_step + 2
    return t1, 2 * t1


def window_gather_taps(
    spec_planes: jnp.ndarray,   # [N, B, 2C] f32 — spec_in re/im planes
    prev_planes: jnp.ndarray,   # [N, B, 2C] f32 — rotated prev planes
    energy: jnp.ndarray,        # [N, B, C]  f32 — energy_c planes
    input_bin: jnp.ndarray,     # [N, B] f32
    pos5: jnp.ndarray,          # [N, 5B] f32 — pred|down_s|down_l|us|ul
    step: jnp.ndarray,          # [N] f32 — the scalar c = clamp(tf,.5,2)
    long_step: int = 5,
    t1: int = 16,
    chunk: int = 8,
    fetch: str | None = None,
    precision=None,
    geom: tuple[int, int] | None = None,
    geom2: tuple[int, int] | None = None,
    out_layout: str = "bm",
):
    """Uncombined taps for the five-family and comb gathers, in the
    exact layouts `_hop_inputs_hoisted` consumes:

        (ga5, gb5) [N, 5B, 2C]  — lower/upper taps at pos5
        (gac, gbc) [N, B, 3C]   — lower/upper taps at input_bin

    The caller combines ``ga*w0 + gb*w1`` at its top level with the
    weights `ops.blockgather.block_gather(return_taps=True)` would
    return (identical formula from the same positions).  Tap values
    match block_gather's wherever the weight is nonzero; where a weight
    is zero the tap may be 0 instead of block_gather's clipped-window
    residue — the combined result is bit-identical either way.

    ``fetch`` selects how each band's w-wide candidate strip is
    pulled out of the overlapped window tensor (None -> the
    ``BAUKLANK_WINFETCH`` env var, default "einsum"):
      - "einsum": [B, ng] one-hot x window einsum at HIGHEST (full f32
        on the GPU) — exact row copies (the default);
      - "gather": ``take_along_axis`` on the ng axis — one contiguous
        w*P-float row per band.  A gather IS a copy, so bit-exactness is
        structural; no [B, ng] mask is ever built.  Its time against
        "einsum" on the GPU is recorded in PERF.md;
      - "einsum_m1": the einsum fetch with EXPLICIT upper-tap masks
        (``m1 = oto == d+1``) instead of the shifted-slice upper-tap
        form — all six masked-sum reductions then share one index map
        over ``rows`` so XLA can multi-output-fuse them into a single
        traversal of the materialized rows tensor (see taps_chunk);
      - "einsum2": TWO-LEVEL strip selection — level 1 fetches one
        nstrip-block coarse strip per (example, g2-band block) anchored
        at the block's min anchor; level 2 picks each band's w-wide
        sub-strip with a one-hot over the ~nstrip-2 8-aligned offsets.
        Selection MACs and mask compares both drop ~20x vs the global
        [c, B, ng] one-hot.  Exact for every input: an integer guard
        (max block-relative strip offset <= nstrip-3 over the batch)
        falls back to the single-level fetch whenever a pathological
        map exceeds the strip — and the peaks map provably keeps the
        anchor slope within [0.25, 2.5] for |semitones| <= 12, so the
        BASELINE matrix always takes the two-level branch (see the
        in-function comment).  ``geom2 = (g2, nstrip)`` (env
        ``BAUKLANK_WIN2GEOM``, default (32, 16));
      - "einsum_bm": the same one-hot einsum but emitting the BAND-MINOR
        layout ``[c, w*P, B]``, with the tap masks built as [c, w, B]
        and the masked sums reducing over the MAJOR w axis.

    ``geom = (g, w)`` sets the window-block stride g and strip width w
    (None -> the ``BAUKLANK_WINGEOM`` env var "g,w", default
    ``window_geom``).  Correctness needs ``w >= g + 2*long_step + 2``
    (worst tap = upper tap of input_bin with the anchor at the start of
    its g-block) and ``b % g == 0``.

    ``out_layout`` selects the tap-tensor layout: "bm" (band-major, the
    shapes above) or "pm" (plane-major — ``(ga5, gb5) [N, 2C, 5B]``,
    ``(gac, gbc) [N, 3C, B]``, bands minor).  Plane-major is the layout
    the downstream consumers want ([H, S, C, K] is band-minor), so the pm
    epilogue lets the caller's weighted combine and complex re-pack run
    with no post-combine relayout; it is the native output layout of the
    einsum_bm fetch.  The per-element arithmetic is identical in either
    layout (bit-exactness unchanged).

    All modes share the pure-0/1 tap selection and the caller-side
    combine; tests/test_windowgather.py pins them bit-identical."""
    assert out_layout in ("bm", "pm"), out_layout
    if fetch is None:
        fetch = os.environ.get("BAUKLANK_WINFETCH", "") or "einsum"
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    if geom is None:
        env = os.environ.get("BAUKLANK_WINGEOM", "")
        if env:
            geom = tuple(int(x) for x in env.split(","))
        else:
            geom = window_geom(input_bin.shape[1], long_step, t1)
    g, w = geom
    n, b, p_spec = spec_planes.shape
    c2 = prev_planes.shape[2]
    ce = energy.shape[2]
    p_all = p_spec + c2 + ce
    assert b % g == 0 and w >= g + 2 * long_step + 2, (b, g, w, long_step)
    ng = b // g
    ncop = -(-w // g)                                     # ceil(w / g)
    lf = float(long_step)
    c = step[:, None]                                     # [N, 1]

    payload = jnp.concatenate([spec_planes, prev_planes, energy], axis=2)

    # window anchor: the lowest family floor is floor(input_bin - L*c)
    anchor = jnp.clip(
        jnp.floor(input_bin - lf * c).astype(jnp.int32), 0, b - 1)
    hi = anchor // g                                      # [N, B]

    # The six families collapse to THREE tap selections in this regime:
    # pred and comb share the position input_bin (one selection over all
    # 10 payload planes), and because the step is the SAME scalar c for
    # every band, us_pos[k] = input_bin[k+1] - c = down_s position at
    # band k+1 and ul_pos[k] = down_l position at band k+L — us/ul taps
    # are exact lane shifts of down_s/down_l taps (their interpolation
    # weights shift identically, being functions of the same float
    # positions), reconstructed at top level below.
    pos_f = [input_bin, pos5[:, b: 2 * b], pos5[:, 2 * b: 3 * b]]
    deltas = []
    for pos in pos_f:
        i0 = jnp.floor(pos).astype(jnp.int32)
        deltas.append(i0 - hi * g)                        # [N, B] tap offset
    delta = jnp.stack(deltas, axis=1)                     # [N, 3, B] int32

    fam_planes = ((0, p_all), (0, p_spec), (0, p_spec))

    def _finish(outs):
        """Shared tail: us/ul taps are lane shifts of down_s/down_l taps
        (positions equal by construction, module docstring); the last
        ``sh`` lanes have no k+sh source — their positions sit below 0,
        where only an upper tap at band 0 can be valid (chainfetch
        tail_fix; the engine itself zeroes these lanes, but the
        block_gather contract sees them).  The band axis is axis 1:
        shift it directly with slice+concat (an earlier form moved the
        band axis to the minor dim and back just to reuse _lshift —
        four relayout passes over [N, B, 2C] tensors for nothing)."""
        ga_ib, gb_ib, ga_ds, gb_ds, ga_dl, gb_dl = outs

        def shifted(ga, gb, pos, sh):
            ptail = pos[:, b - sh:]                       # [N, sh]
            i0 = jnp.floor(ptail).astype(jnp.int32)
            val = jnp.where(
                ((i0 + 1) == 0)[:, :, None], spec_planes[:, :1, :], 0.0)
            gb = jnp.concatenate([gb[:, sh:], val], axis=1)
            ga = jnp.concatenate([ga[:, sh:], jnp.zeros_like(val)], axis=1)
            return ga, gb

        ga_us, gb_us = shifted(ga_ds, gb_ds, pos5[:, 3 * b: 4 * b], 1)
        ga_ul, gb_ul = shifted(ga_dl, gb_dl, pos5[:, 4 * b:], long_step)
        ga5 = jnp.concatenate(
            [ga_ib[..., :p_spec], ga_ds, ga_dl, ga_us, ga_ul], axis=1)
        gb5 = jnp.concatenate(
            [gb_ib[..., :p_spec], gb_ds, gb_dl, gb_us, gb_ul], axis=1)
        gac, gbc = ga_ib[..., p_spec:], gb_ib[..., p_spec:]
        return ga5, gb5, gac, gbc

    def _finish_pm(outs):
        """Plane-major twin of _finish: tap tensors are [N, Pf, B]
        (bands on LANES), band shifts slice the minor axis, and the
        family concat rides axis 2 — ga5/gb5 come out [N, 2C, 5B] and
        gac/gbc [N, 3C, B], the layouts the caller's plane-major combine
        epilogue consumes with no relayout pass.  Same us/ul tail law as
        _finish; spec band-0 is one [N, 2C] row broadcast on lanes."""
        ga_ib, gb_ib, ga_ds, gb_ds, ga_dl, gb_dl = outs
        spec0 = spec_planes[:, 0, :]                  # [N, 2C]

        def shifted(ga, gb, pos, sh):
            ptail = pos[:, b - sh:]                   # [N, sh]
            i0 = jnp.floor(ptail).astype(jnp.int32)
            val = jnp.where(
                ((i0 + 1) == 0)[:, None, :], spec0[:, :, None], 0.0)
            gb = jnp.concatenate([gb[:, :, sh:], val], axis=2)
            ga = jnp.concatenate(
                [ga[:, :, sh:], jnp.zeros_like(val)], axis=2)
            return ga, gb

        ga_us, gb_us = shifted(ga_ds, gb_ds, pos5[:, 3 * b: 4 * b], 1)
        ga_ul, gb_ul = shifted(ga_dl, gb_dl, pos5[:, 4 * b:], long_step)
        ga5 = jnp.concatenate(
            [ga_ib[:, :p_spec], ga_ds, ga_dl, ga_us, ga_ul], axis=2)
        gb5 = jnp.concatenate(
            [gb_ib[:, :p_spec], gb_ds, gb_dl, gb_us, gb_ul], axis=2)
        gac, gbc = ga_ib[:, p_spec:], gb_ib[:, p_spec:]
        return ga5, gb5, gac, gbc

    def _dispatch(outs, native_pm=False):
        if out_layout == "pm":
            if not native_pm:
                outs = [jnp.transpose(o, (0, 2, 1)) for o in outs]
            return _finish_pm(outs)
        if native_pm:
            outs = [jnp.transpose(o, (0, 2, 1)) for o in outs]
        return _finish(outs)

    def _tap_outs(rows, delta_c):
        """The PURE 0/1 tap stage shared by the einsum/gather/einsum2
        fetches: per family a lower-tap mask + the upper tap from the
        SAME mask against a one-shifted payload slice (halves mask
        generation; d <= w-2 by the geometry bound keeps the shifted
        range covering every in-window match; the one reachable
        out-of-window case d == -1 — position in (-1, 0), only an
        upper tap at band 0 — is patched with an exact 0/1 copy, and
        both terms are exact under FMA contraction because whenever one
        is nonzero the other is exactly zero).  A masked sum, not a
        dot: at most ONE nonzero term per output, exact under any
        lowering (chunked-gather FMA hazard: no weight in here).  A
        stacked broadcast-sum (rows[:,:,None]*m_all) would materialize
        the [c,B,6,w,P] product, and a stacked "cbmt,cbtp->cbmp" einsum
        emits [c*B]-batched tiny dots."""
        oto = jnp.arange(w, dtype=jnp.int32)
        outs = []
        for f, (p0, p1) in enumerate(fam_planes):
            d = delta_c[:, f, :, None]                    # [c, B, 1]
            m0 = (oto == d).astype(jnp.float32)           # [c, B, w]
            seg = rows[..., p0:p1]                        # [c, B, w, Pf]
            outs.append(jnp.sum(seg * m0[..., None], axis=2))
            gb = jnp.sum(
                seg[:, :, 1:, :] * m0[:, :, : w - 1, None], axis=2)
            gb = gb + (
                (d[..., 0] == -1).astype(jnp.float32)[..., None]
                * seg[:, :, 0, :]
            )
            outs.append(gb)
        return tuple(outs)

    if fetch == "einsum2":
        # TWO-LEVEL strip selection: the [c, B, ng] one-hot + its einsum
        # are the dominant non-tap cost of the default fetch.  Bands in
        # a g2-wide output block have nearby anchors whenever the time->frequency map's local slope is
        # moderate — and the peaks map PROVABLY bounds the anchor slope
        # to [0.25, 2.5] for mult in [0.5, 2] (the BASELINE +-12
        # semitone range): interior gradients are 1 + 6t(1-t)*(chord-1)
        # with chord slopes in the map-slope hull [min(1,1/mult),
        # max(1,1/mult)], exterior regions are pure translation
        # (engine/spectral._find_peaks_map_batched).  So: level 1
        # selects ONE nstrip-block coarse strip per (example, band
        # block) anchored at the block's min anchor (one-hot over ng8
        # raw 8-band blocks, but only B/g2 rows); level 2 picks each
        # band's w-wide sub-strip with a one-hot over nstrip-2 8-aligned
        # offsets.  Selection MACs and mask compares both drop ~20x.
        # An EXACT integer guard (max fbrel <= nstrip-3, checked over
        # the whole batch) falls back to the single-level fetch for
        # pathological maps (|semitones| > 12 can exceed any fixed
        # strip), so the mode is exact for every input by construction.
        if geom2 is None:
            env2 = os.environ.get("BAUKLANK_WIN2GEOM", "")
            geom2 = (tuple(int(x) for x in env2.split(","))
                     if env2 else (32, 16))
        g2, nstrip = geom2
        w = 2 * long_step + 10                  # g'=8 sub-strips, w=20
        if b % g2 or b % 8 or nstrip < -(-w // 8) + 1:
            return window_gather_taps(
                spec_planes, prev_planes, energy, input_bin, pos5, step,
                long_step=long_step, t1=t1, chunk=chunk, fetch="einsum",
                precision=precision, geom=(8, w) if b % 8 == 0 else None,
                out_layout=out_layout)
        nb = b // g2
        ng8 = b // 8
        anc_b = anchor.reshape(n, nb, g2)
        s0 = jnp.min(anc_b, axis=2) // 8                  # [N, nb]
        fbrel = (anc_b // 8 - s0[:, :, None]).reshape(n, b)
        ok = jnp.max(fbrel) <= nstrip - (w + 7) // 8      # exact int guard
        # deltas relative to the g'=8 strip start (hi8*8) — identical to
        # the single-level g=8 form's, so the tap stage is unchanged
        delta8 = jnp.stack(
            [jnp.floor(p).astype(jnp.int32) - (anchor // 8) * 8
             for p in pos_f], axis=1)                     # [N, 3, B]
        pay_p = jnp.pad(payload, ((0, 0), (0, nstrip * 8), (0, 0)))

        def taps2_chunk(args):
            """PURE 0/1 two-level selection + the shared tap stage."""
            s0_c, fb_c, delta_c, pay_c = args
            cc = s0_c.shape[0]
            raw = pay_c.reshape(cc, ng8 + nstrip, 8 * p_all)
            jj = jnp.arange(ng8, dtype=jnp.int32)
            oh1 = (s0_c[..., None] == jj).astype(jnp.float32)  # [c, nb, ng8]
            strip = jnp.concatenate(
                [jnp.einsum("cna,car->cnr", oh1, raw[:, j: j + ng8],
                            precision=precision)
                 for j in range(nstrip)], axis=2)         # [c, nb, ns*8*P]
            slide = jnp.stack(
                [strip[:, :, 8 * o * p_all: (8 * o + w) * p_all]
                 for o in range(nstrip - (w + 7) // 8 + 1)],
                axis=2)                                   # [c, nb, no, w*P]
            oo = jnp.arange(slide.shape[2], dtype=jnp.int32)
            oh2 = (fb_c.reshape(cc, nb, g2)[..., None] == oo).astype(
                jnp.float32)                              # [c, nb, g2, no]
            rows = jnp.einsum(
                "cnbo,cnor->cnbr", oh2, slide, precision=precision,
            ).reshape(cc, b, w, p_all)
            return _tap_outs(rows, delta_c)

        def _two(_):
            if n > chunk:
                pad_n = (-n) % chunk
                def padn(x):
                    return jnp.pad(
                        x, ((0, pad_n),) + ((0, 0),) * (x.ndim - 1))
                s0_p, fb_p, d_p, p_p = map(padn, (s0, fbrel, delta8, pay_p))
                nc = (n + pad_n) // chunk
                outs = jax.lax.map(
                    taps2_chunk,
                    (s0_p.reshape(nc, chunk, nb),
                     fb_p.reshape(nc, chunk, b),
                     d_p.reshape(nc, chunk, 3, b),
                     p_p.reshape(nc, chunk, ng8 + nstrip, 8 * p_all)),
                )
                outs = [o.reshape(n + pad_n, b, -1)[:n] for o in outs]
            else:
                outs = list(taps2_chunk(
                    (s0, fbrel, delta8,
                     pay_p.reshape(n, ng8 + nstrip, 8 * p_all))))
            return _dispatch(outs)

        def _fallback(_):
            return window_gather_taps(
                spec_planes, prev_planes, energy, input_bin, pos5, step,
                long_step=long_step, t1=t1, chunk=chunk, fetch="einsum",
                precision=precision, geom=(8, w), out_layout=out_layout)

        return jax.lax.cond(ok, _two, _fallback, None)

    padded = jnp.pad(payload, ((0, 0), (0, ncop * g), (0, 0)))
    copies = [
        padded[:, k * g: k * g + b].reshape(n, ng, g, p_all)
        for k in range(ncop)
    ]
    win = jnp.concatenate(copies, axis=2)[:, :, :w].reshape(n, ng, w * p_all)

    def taps_chunk(args):
        """PURE 0/1 selection (chunked-gather FMA hazard: no weight may
        touch this body — ops/blockgather.py taps_chunk)."""
        hi_c, delta_c, win_c = args                       # [c,B] [c,6,B] [c,ng,R]
        if fetch == "einsum_bm":
            # band-minor: rows come off the einsum as [c, R, B] and every
            # mask/masked-sum keeps B on the minor axis
            jj = jnp.arange(ng, dtype=jnp.int32)
            oh = (hi_c[..., None] == jj).astype(jnp.float32)  # [c, B, ng]
            rows_t = jnp.einsum(
                "cbj,cjr->crb", oh, win_c, precision=precision,
            ).reshape(hi_c.shape[0], w, p_all, b)         # [c, w, P, B]
            oto = jnp.arange(w, dtype=jnp.int32)
            outs = []
            for f, (p0, p1) in enumerate(fam_planes):
                d = delta_c[:, f, :]                      # [c, B]
                m0 = (oto[None, :, None] == d[:, None, :]).astype(
                    jnp.float32)                          # [c, w, B]
                seg = rows_t[:, :, p0:p1, :]              # [c, w, Pf, B]
                ga = jnp.sum(seg * m0[:, :, None, :], axis=1)  # [c, Pf, B]
                gb = jnp.sum(
                    seg[:, 1:, :, :] * m0[:, : w - 1, None, :], axis=1)
                gb = gb + (
                    (d == -1).astype(jnp.float32)[:, None, :]
                    * seg[:, 0, :, :]
                )
                if out_layout == "pm":
                    # plane-major IS this branch's native layout — the
                    # band-major moveaxis (the only relayout the bm
                    # fetch ever paid) disappears entirely
                    outs.append(ga)                       # [c, Pf, B]
                    outs.append(gb)
                else:
                    outs.append(jnp.moveaxis(ga, 1, 2))   # [c, B, Pf]
                    outs.append(jnp.moveaxis(gb, 1, 2))
            return tuple(outs)
        if fetch == "gather":
            rows = jnp.take_along_axis(
                win_c, hi_c[:, :, None], axis=1
            ).reshape(hi_c.shape[0], b, w, p_all)
        elif fetch == "stub_rows":
            # benchmark-only: drop mask gen + selection, keep tap stage
            rows = win_c[:, :1, : w * p_all].reshape(
                hi_c.shape[0], 1, w, p_all
            ) * jnp.ones((1, b, 1, 1), jnp.float32)
        else:
            jj = jnp.arange(ng, dtype=jnp.int32)
            oh = (hi_c[..., None] == jj).astype(jnp.float32)  # [c, B, ng]
            rows = jnp.einsum(
                "cbj,cjr->cbr", oh, win_c,
                precision=precision,
            ).reshape(hi_c.shape[0], b, w, p_all)
        oto = jnp.arange(w, dtype=jnp.int32)
        if fetch == "einsum_m1":
            # explicit upper-tap masks instead of the shifted-slice form:
            # every one of the six masked-sum reductions then shares the
            # SAME index map over `rows`, letting XLA multi-output-fuse
            # them into one traversal.  The d == -1 patch disappears:
            # m1 = (oto == d+1) hits band 0 exactly there, and d <= w-2
            # keeps d+1 in-window.  Both masks are 0/1 so bit-exactness
            # is unchanged.  MEASURED WASH (module docstring) — the tap
            # stage is not re-read-bound.
            outs = []
            for f, (p0, p1) in enumerate(fam_planes):
                d = delta_c[:, f, :, None]                # [c, B, 1]
                m0 = (oto == d).astype(jnp.float32)       # [c, B, w]
                m1 = (oto == d + 1).astype(jnp.float32)
                seg = rows[..., p0:p1]                    # [c, B, w, Pf]
                outs.append(jnp.sum(seg * m0[..., None], axis=2))
                outs.append(jnp.sum(seg * m1[..., None], axis=2))
            return tuple(outs)
        return _tap_outs(rows, delta_c)

    native_pm = fetch == "einsum_bm" and out_layout == "pm"
    if n > chunk:
        pad_n = (-n) % chunk
        def padn(x):
            return jnp.pad(x, ((0, pad_n),) + ((0, 0),) * (x.ndim - 1))
        hi_p, delta_p, win_p = map(padn, (hi, delta, win))
        nc = (n + pad_n) // chunk
        outs = jax.lax.map(
            taps_chunk,
            (
                hi_p.reshape(nc, chunk, b),
                delta_p.reshape(nc, chunk, 3, b),
                win_p.reshape(nc, chunk, ng, w * p_all),
            ),
        )
        if native_pm:
            outs = [o.reshape(n + pad_n, -1, b)[:n] for o in outs]
        else:
            outs = [o.reshape(n + pad_n, b, -1)[:n] for o in outs]
    else:
        outs = list(taps_chunk((hi, delta, win)))
    return _dispatch(outs, native_pm=native_pm)
