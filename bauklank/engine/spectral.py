"""Blob-exact spectral hop — the reference engine's algorithm in JAX.

This is the fidelity core: a jittable, batchable restatement of the
reverse-engineered reference DSP (docs/WASM-ALGO.md; the opaque WASM blob
at reference app/SignalsmithStretch.mjs:265, pinned hop-exact by
tools/golden_wasm/pymodel.py against live memory dumps).  One call maps
(carried state, two analyses, controls) -> (new state, output spectrum),
exactly like the blob's processSpectrum:

1. rotate carried spectra to the new frame position,
2. peak-based frequency map (channel-summed energy -> two-pass one-pole
   smoothing -> maximal runs -> smoothstep output map with gradient),
3. per-channel predictions (interpolated energy/input, time-twist against
   the previous-interval analysis, shared stale prediction buffer),
4. sequential Gauss-Seidel phase propagation over bands with short (1) and
   long (round(fft/interval)) neighbors, max-energy channel leading and the
   other channels phase-locked to it.

Batched mapping: steps 1-3 are elementwise/scan-free batched ops (the one-pole
smoother is an affine ``associative_scan``); step 4 is irreducibly
sequential in the band axis (each band's phase depends on finalized lower
bands), so it runs as one ``lax.scan`` over bands carrying a ring of the
last ``long_step`` outputs — the body is a handful of complex mul-adds that
vectorize across streams x channels, so a whole serving pool advances the
scan in lockstep.  No data-dependent shapes anywhere.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "SpectralConfig",
    "SpectralState",
    "fft_size_for",
    "blob_window",
    "init_spectral_state",
    "spectral_hop",
    "spectral_hop_batched",
]

EPS = 1e-15  # the blob's noise floor (measured; pymodel.EPS)


def fft_size_for(block: int) -> int:
    """Smallest ``2^a * m >= block`` with ``m in {1, 3, 5}`` — the blob's
    measured FFT-size rule (docs/WASM-ALGO.md "Sizes")."""
    best = None
    for m in (1, 3, 5):
        size = m
        while size < block:
            size *= 2
        if best is None or size < best:
            best = size
    return best


@functools.lru_cache(maxsize=64)
def blob_window(block: int, interval: int) -> np.ndarray:
    """The blob's exact analysis/synthesis window (identical pair):
    periodic-centered Kaiser with the heuristic-optimal bandwidth law,
    per-sample forced-COLA normalized (sum_h w^2(n - h*interval) = 1).
    Machine-precision fit, err 1e-6..5e-8 across 14 configs
    (docs/WASM-ALGO.md "Window")."""
    try:
        from scipy.special import i0 as bessel_i0
    except ImportError:  # pragma: no cover
        def bessel_i0(x):
            x = np.asarray(x, np.float64)
            out = np.zeros_like(x)
            term = np.ones_like(x)
            for m in range(1, 40):
                out += term
                term = term * (x / (2 * m)) ** 2
            return out + term

    ov = block / interval
    bw = ov + 8.0 / (ov + 3.0) ** 2 + max(3.0 - ov, 0.0) / 4.0
    beta = np.pi * np.sqrt(bw * bw / 4.0 - 1.0)
    n = np.arange(block)
    x = 2.0 * (n + 0.5) / block - 1.0
    k = bessel_i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / bessel_i0(beta)
    s = np.zeros(block)
    hops = block // interval + 2
    for h in range(-hops, hops + 1):
        idx = n - h * interval
        ok = (idx >= 0) & (idx < block)
        s[ok] += k[idx[ok]] ** 2
    return (k / np.sqrt(s)).astype(np.float64)


class SpectralConfig(NamedTuple):
    """Static shapes for the fidelity core (hashable -> jit static arg).

    formants: compile the blob's step-5 formant processing into the hop
    (envelope + f0 trackers + smoothing + per-band energy scaling).  Off by
    default: formant-neutral streams skip the work entirely, and the blob
    itself gates the step on "formantFactor != 1, or compensation and
    mapping" (docs/WASM-ALGO.md step 5) — when compiled in, neutral params
    still produce the exact identity gain and frozen EMA trackers.

    split: splitComputation mode (reference _configure ABI,
    app/SignalsmithStretch.mjs:787-801).  Only the frame drive differs —
    split-off zeroes the first interval of the prev-analysis window and
    places frames one interval earlier (decoded by store-tracing,
    tools/golden_wasm/verify_splitoff.py); the hop math is identical.
    """

    channels: int
    block: int
    interval: int
    formants: bool = False
    split: bool = True

    @property
    def fft(self) -> int:
        return fft_size_for(self.block)

    @property
    def bands(self) -> int:
        return self.fft // 2

    @property
    def long_step(self) -> int:
        return int(round(self.fft / self.interval))


class SpectralState(NamedTuple):
    """Carried per-stream state (pytree; batch with leading axes)."""

    prev_output: jnp.ndarray       # [C, bands] complex64 — carried spectrum
    prev_pred_energy: jnp.ndarray  # [C, bands] float32 — stale pred buffer
    rng: jnp.ndarray               # [] uint32 — MINSTD state (timeFactor > 2)
    f_value_ema: jnp.ndarray       # [] f32 — formant f0 tracker (blob 6688)
    f_weighted_ema: jnp.ndarray    # [] f32 — formant f0 tracker (blob 6684)


def init_spectral_state(cfg: SpectralConfig, seed: int = 1) -> SpectralState:
    # seed: the blob seeds from std::random_device at construction (reduced
    # mod 2^31-1, clamped >= 1; docs/WASM-ALGO.md "Misc"); exactness tests
    # pass the live engine's observed state (addr 6672).
    return _init_spectral_state_jit(cfg, int(seed))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _init_spectral_state_jit(cfg: SpectralConfig, seed: int) -> SpectralState:
    # jitted so the complex zeros materialize ON DEVICE (same treatment
    # as engine.core._init_state_jit)
    return SpectralState(
        prev_output=jnp.zeros((cfg.channels, cfg.bands), jnp.complex64),
        prev_pred_energy=jnp.zeros((cfg.channels, cfg.bands), jnp.float32),
        rng=jnp.uint32(seed),
        f_value_ema=jnp.float32(0.0),
        f_weighted_ema=jnp.float32(0.0),
    )


# ------------------------------------------------------------------ MINSTD
MINSTD_M = 2147483647  # 2^31 - 1 (Mersenne prime)
MINSTD_A = 48271


@functools.lru_cache(maxsize=16)
def _minstd_powers(n_draws: int) -> np.ndarray:
    """[n_draws] uint32: 48271^(k+1) mod (2^31-1) for k = 0..n_draws-1."""
    out = np.empty(n_draws, np.uint32)
    p = 1
    for k in range(n_draws):
        p = (p * MINSTD_A) % MINSTD_M
        out[k] = p
    return out


def _modmul31(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """(x * y) mod (2^31 - 1), exact, for uint32 inputs < 2^31-1.

    16-bit limb products keep every intermediate inside uint32; the Mersenne
    identity 2^31 ≡ 1 folds the high parts back (2^32 ≡ 2).  This is what
    lets the whole MINSTD draw stream of a hop vectorize: the k-th draw is
    s·a^k mod M, so one elementwise modmul against precomputed powers
    replaces a 2·bands-step sequential generator.
    """
    m = jnp.uint32(0x7FFFFFFF)
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    x0, x1 = x & jnp.uint32(0xFFFF), x >> 16
    y0, y1 = y & jnp.uint32(0xFFFF), y >> 16
    lo = x0 * y0                     # < 2^32
    mid = x1 * y0 + x0 * y1          # < 2^32 (x1, y1 < 2^15)
    hi = x1 * y1                     # < 2^30

    def fold(u):  # u < 2^32  ->  u mod-ish: value preserved mod M, <= 2^31
        return (u >> 31) + (u & m)

    acc = fold(hi * jnp.uint32(2) + (mid >> 15))
    acc = fold(acc + ((mid & jnp.uint32(0x7FFF)) << 16))
    acc = fold(acc + fold(lo))
    return jnp.where(acc >= m, acc - m, acc)


def _minstd_steps(seed: jnp.ndarray, time_factor: jnp.ndarray, bands: int,
                  seq: jnp.ndarray | None = None):
    """Vertical time steps for one hop: (d_down [B], d_up [B], new_seed).

    timeFactor <= 2: the deterministic clamp(tf, 0.5, 2) everywhere.
    timeFactor > 2 (rate < 0.5 — the kiosk regime): the blob's MINSTD-
    random steps, draw-for-draw (decoded from the translated blob; pinned
    by tools/golden_wasm/pymodel._minstd_draws and tests/test_pymodel.py):
    value = f32((2·tf−4)·2⁻³¹·u32(s'−1) + (4−tf)); band 0 draws only UP,
    interior bands DOWN then UP, the last band only DOWN; each draw is
    shared by its short/long pair (long scales by L).  The stream is data-
    independent, so all 2B−2 draws vectorize as s·a^k mod M.

    ``seq``: the [2B-2] uint32 draw stream, when the caller precomputed it
    (``_hop_inputs_hoisted`` gates the modmul batch behind the regime cond
    — at tf <= 2 everywhere the draws are discarded by the ``use`` select,
    so a dummy stream is exact).  The f32 rounding ops below always run at
    top level: only the INTEGER modmuls may sit inside a lax.cond branch
    (no mul+add for XLA to FMA-contract — the ops/blockgather.py lesson).
    """
    n = 2 * bands - 2
    if seq is None:
        pows = jnp.asarray(_minstd_powers(n))
        seq = _modmul31(seed, pows)                           # s_1 .. s_n
    v32 = jnp.maximum(time_factor.astype(jnp.float32), jnp.float32(0.5))
    v45 = jnp.where(v32 > 2.0, jnp.float32(4.0), jnp.float32(0.0)) - v32
    v46 = (v32 - v45) * jnp.float32(2.0 ** -31)
    vals = v46 * (seq - jnp.uint32(1)).astype(jnp.float32) + v45
    zero = jnp.zeros((1,), jnp.float32)
    dd_rand = jnp.concatenate([zero, vals[1::2]])             # [B]
    du_rand = jnp.concatenate([vals[0::2], zero])             # [B]
    bts = jnp.clip(time_factor, 0.5, 2.0).astype(jnp.float32)
    use = time_factor > 2.0
    d_down = jnp.where(use, dd_rand, bts)
    d_up = jnp.where(use, du_rand, bts)
    new_seed = jnp.where(use, _modmul31(seed, jnp.asarray(_minstd_powers(n)[-1])), seed)
    return d_down, d_up, new_seed


def _unit_phase(phase: np.ndarray) -> jnp.ndarray:
    """e^{i*phase} built on-device from real constants."""
    p = np.asarray(phase, np.float32)
    return jax.lax.complex(jnp.cos(jnp.asarray(p)), jnp.sin(jnp.asarray(p)))


def _smooth_bidirectional(e: jnp.ndarray, coef, carry):
    """The blob's two-pass one-pole smoother (backward then forward) with
    the carry threaded between passes.  y_b = y_prev + coef*(e_b - y_prev)
    is affine, so each direction is one ``associative_scan``.

    e: [..., B] -> (smoothed [..., B], carry [...]).  ``coef`` may be a
    scalar or an array over the leading (batch) axes — constant along B, so
    both scan directions see the same coefficients.
    """
    if isinstance(coef, (float, int)):
        # python-scalar path: 1-coef subtracts in f64 THEN casts, exactly
        # like the original full_like(vals, 1.0 - coef) (bit-compat with
        # the hop-exact pymodel pinning)
        a = jnp.broadcast_to(jnp.asarray(1.0 - coef, e.dtype), e.shape)
        coef = jnp.broadcast_to(jnp.asarray(coef, e.dtype), e.shape)
    else:
        coef = jnp.asarray(coef, e.dtype)
        if coef.ndim:
            coef = coef[..., None]
        coef = jnp.broadcast_to(coef, e.shape)
        a = 1.0 - coef

    def compose(p, q):
        a1, b1 = p
        a2, b2 = q
        return a1 * a2, a2 * b1 + b2

    def affine_scan(vals, c0):
        # y_b = a*y_{b-1} + coef*vals_b, y_{-1} = c0
        aa, bb = jax.lax.associative_scan(compose, (a, coef * vals), axis=-1)
        return aa * c0[..., None] + bb

    bwd = affine_scan(e[..., ::-1], carry)[..., ::-1]
    c_mid = bwd[..., 0]
    fwd = affine_scan(bwd, c_mid)
    return fwd, fwd[..., -1]


def _twosum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (IEEE round-to-nearest)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _df_combine(x, y):
    """Associative add on double-float32 pairs (hi, lo) ~ 49-bit mantissa."""
    hi, e = _twosum(x[0], y[0])
    lo = x[1] + y[1] + e
    s = hi + lo
    return s, lo - (s - hi)


def _comp_cumsum(x: jnp.ndarray, axis: int):
    """Compensated cumulative sum -> (hi, lo) double-float32 pairs.

    Plain f32 prefix-sum DIFFERENCES catastrophically cancel when a weak
    run sits on top of a large accumulated prefix (relative error ~
    eps * prefix/run — garbage centers for faint high-band peaks).  The
    compensated pair keeps ~49 mantissa bits, so even a 1e7 prefix/run
    ratio leaves more precision than a direct f32 sum.  The prefix is an
    ``associative_scan`` tree: its combination order is fixed by the tree,
    not by the backend's loop order."""
    zeros = jnp.zeros_like(x)
    return jax.lax.associative_scan(_df_combine, (x, zeros), axis=axis)


def _peaks_block_t(bands: int) -> int | None:
    """blockgather granularity for the peaks map on this band grid.

    Small blocks keep the 2t-wide tap stage narrow; the smallest block
    that divides the band grid is used."""
    return next((t for t in (8, 16, 32, 64) if bands % t == 0), None)


def _find_peaks_map(energy: jnp.ndarray, smoothed: jnp.ndarray,
                    mult: jnp.ndarray, limit: jnp.ndarray, bands: int, fft: int):
    """Vectorized findPeaks + outputMap (docs/WASM-ALGO.md steps 4c-4d).

    energy, smoothed: [B].  Returns (input_bin [B], grad [B]).

    Peaks are maximal runs where energy > smoothed; each run's inputBin is
    its energy-weighted mean band.  The output position maps the peak
    frequency f=(bin+0.5)/fft through: f*mult below the tonality limit,
    f + (mult-1)*limit above; outputBin = f_out*fft - 0.5.  Between
    adjacent peaks the map is a smoothstep blend with analytic gradient;
    outside the end peaks it is a pure translation.

    On blockgather-compatible band grids this delegates to the scatter-free
    batched form (N=1) so the scan/golden path and the serving path stay
    op-identical (the hoisted micro-check demands maxdiff==0); odd grids
    keep the scatter fallback below.
    """
    t_blk = _peaks_block_t(bands)
    if t_blk is not None:
        ib, gr = _find_peaks_map_batched(
            energy[None], smoothed[None],
            jnp.asarray(mult, jnp.float32)[None],
            jnp.asarray(limit, jnp.float32)[None],
            bands, fft, t_blk)
        return ib[0], gr[0]
    return _find_peaks_map_scatter(energy, smoothed, mult, limit, bands, fft)


def _find_peaks_map_scatter(energy: jnp.ndarray, smoothed: jnp.ndarray,
                            mult: jnp.ndarray, limit: jnp.ndarray,
                            bands: int, fft: int):
    """Scatter-add form of :func:`_find_peaks_map` (fallback for band
    grids no blockgather block size divides; also the A/B reference in
    benchmarks/profile_peaks.py)."""
    b_idx = jnp.arange(bands, dtype=jnp.float32)
    above = energy > smoothed
    prev_above = jnp.concatenate([jnp.zeros_like(above[:1]), above[:-1]])
    run_start = above & ~prev_above
    # run ids: 1-based id per band of the run it belongs to (0 = no run)
    run_id = jnp.cumsum(run_start.astype(jnp.int32)) * above.astype(jnp.int32)
    seg = jnp.where(above, run_id - 1, bands - 1)  # park non-run bands in a
    # scratch slot; they contribute zero weight anyway
    w = jnp.where(above, energy, 0.0)
    sum_e = jnp.zeros((bands,), energy.dtype).at[seg].add(w)
    sum_eb = jnp.zeros((bands,), energy.dtype).at[seg].add(w * b_idx)
    n_peaks = run_id.max()  # dynamic scalar (traced)
    valid = jnp.arange(bands) < n_peaks
    center = jnp.where(valid, sum_eb / jnp.maximum(sum_e, 1e-30), 0.0)  # [B]
    f_in = (center + 0.5) / fft
    f_out = jnp.where(f_in > limit, f_in + (mult - 1.0) * limit, f_in * mult)
    out_bin = f_out * fft - 0.5
    # pad invalid tail so the rank count keeps every band below the sentinel
    out_sorted = jnp.where(valid, out_bin, jnp.inf)

    # per output band: the segment [p, q) it falls in.
    # idx[b] = #(out_sorted <= b) == searchsorted(out_sorted, b, 'right'),
    # but since the queries are the integer band grid it reduces to a
    # histogram + cumsum (a sort-based searchsorted costs a [2B] sort per
    # stream): 1{x <= b} == 1{b >= ceil(x)}.
    j = jnp.clip(jnp.ceil(out_sorted), 0.0, float(bands)).astype(jnp.int32)
    j = jnp.where(jnp.isfinite(out_sorted), j, bands)  # sentinels never count
    hist = jnp.zeros((bands + 1,), jnp.int32).at[j].add(valid.astype(jnp.int32))
    idx = jnp.cumsum(hist)[:bands]                     # in [0, n_peaks]
    has = n_peaks > 0
    i_p = jnp.clip(idx - 1, 0, jnp.maximum(n_peaks - 1, 0))
    i_q = jnp.clip(idx, 0, jnp.maximum(n_peaks - 1, 0))
    p_in, p_out = center[i_p], out_bin[i_p]
    q_in, q_out = center[i_q], out_bin[i_q]
    interior = (idx > 0) & (idx < n_peaks)
    # translation anchor for the exterior regions (first or last peak)
    a_in = jnp.where(idx <= 0, center[0], p_in)
    a_out = jnp.where(idx <= 0, out_bin[0], p_out)
    span = q_out - p_out
    safe_span = jnp.where(jnp.abs(span) > 1e-30, span, 1.0)
    t = (b_idx - p_out) / safe_span
    dd = (q_in - p_in) - span
    ib_mid = (p_in - p_out) + b_idx + t * t * (3.0 - 2.0 * t) * dd
    gr_mid = 1.0 + 6.0 * t * (1.0 - t) * dd / safe_span
    ib_ext = (a_in - a_out) + b_idx
    input_bin = jnp.where(interior, ib_mid, ib_ext)
    grad = jnp.where(interior, gr_mid, 1.0)
    input_bin = jnp.where(has, input_bin, b_idx)
    grad = jnp.where(has, grad, 1.0)
    return input_bin, grad


def _count_leq_blocked(u: jnp.ndarray, out_len: int, t: int,
                       chunk: int = 16) -> jnp.ndarray:
    """``count[n, q] = #(s : u[n, s] <= q)`` for the integer query grid
    q in [0, out_len), u int32 in [0, out_len] (the value out_len counts
    nowhere).  Decomposed block-wise so the count rides one
    0/1 bf16 einsum (exact: 0/1 products are exact in bf16, f32
    accumulation of <= source-length ones is exact):

        count[kk*t + r] = #(u//t < kk) + einsum_s A[s,kk] R[s,r]

    with A = (u//t == kk), R = (u%t <= r).  Serves both the peaks-map
    searchsorted (``idx[b] = #(out_sorted <= b)``) and the sort-free
    run-boundary compaction (``start_pos[s] = #(cum_starts <= s)``)."""
    n, src = u.shape
    nblk = out_len // t
    kb = u // t
    rb = u - kb * t

    def count_chunk(args):
        kb_c, rb_c = args
        a = (kb_c[:, :, None] == jnp.arange(nblk)[None, None, :]).astype(
            jnp.bfloat16)
        r = (rb_c[:, :, None] <= jnp.arange(t)[None, None, :]).astype(
            jnp.bfloat16)
        # bf16 operands at DEFAULT precision: the bf16 tensor-core path
        # with f32 accumulation on the GPU — exact here (0/1 products,
        # integer sums far below 2^24)
        within = jnp.einsum(
            "nsk,nsr->nkr", a, r, precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)
        counts = within[:, :, -1]                               # block totals
        coarse = jnp.cumsum(counts, axis=1) - counts            # exclusive
        return jnp.round(coarse[:, :, None] + within).astype(jnp.int32).reshape(
            kb_c.shape[0], out_len)

    if n > chunk:
        # pad N up to a chunk multiple (pad rows use u = out_len, which
        # counts nowhere) — chunking must never silently disable: the
        # full [N, src, nblk] masks are the documented transient hazard
        # (ADVICE r3 / ops/blockgather.py)
        pad_n = (-n) % chunk
        kbp = jnp.pad(kb, ((0, pad_n), (0, 0)),
                      constant_values=out_len // t)
        rbp = jnp.pad(rb, ((0, pad_n), (0, 0)))
        return jax.lax.map(
            count_chunk,
            (kbp.reshape(-1, chunk, src), rbp.reshape(-1, chunk, src)),
        ).reshape(n + pad_n, out_len)[:n]
    return count_chunk((kb, rb))


def _find_peaks_map_batched(
    energy: jnp.ndarray,    # [N, B]
    smoothed: jnp.ndarray,  # [N, B]
    mult: jnp.ndarray,      # [N]
    limit: jnp.ndarray,     # [N]
    bands: int, fft: int, t_blk: int,
):
    """Batched scatter-free :func:`_find_peaks_map` (also the N=1 core of
    the per-example form — both paths share every op, keeping the hoisted
    micro-check's maxdiff==0 by construction).

    Scatter-free redesign (the scatters are the costly components that
    benchmarks/profile_peaks.py times):

    - segment sums -> COMPENSATED prefix-sum differences at run
      boundaries: runs are contiguous band intervals, so
      sum(w[s..e]) = cs[e] - cs[s-1]; double-float32 pairs kill the
      cancellation (see :func:`_comp_cumsum`);
    - run boundaries -> rank-count compaction: start/end band positions
      are monotone in run order, so the s-th boundary position is itself
      a count over the inclusive boundary cumsum
      (``start_pos[s] = #(cum_starts <= s)``, :func:`_count_leq_blocked`)
      — no sort, no scatter (the r4 sort form cost two [N, B] sorts);
    - boundary + rank lookups ride ``ops.blockgather`` one-hot block
      matmuls (integer positions: frac == 0, rows copy bit-exactly);
    - the rank count (searchsorted of the integer band grid in the sorted
      ``out_bin``) -> a chunked compare-sum (no histogram scatter):
      idx[b] = #(out_sorted <= b), a fused compare+reduce;
    - run-slot arrays are [B/2] not [B]: maximal runs are separated by
      at least one gap band, so n_peaks <= ceil(B/2).

    Returns (input_bin [N, B], grad [N, B])."""
    from bauklank.ops.blockgather import block_gather

    n = energy.shape[0]
    b_idx = jnp.arange(bands, dtype=jnp.float32)
    slots = -(-((bands + 1) // 2) // t_blk) * t_blk             # ceil(B/2)->t
    above = energy > smoothed                                   # [N, B]
    prev_above = jnp.concatenate(
        [jnp.zeros_like(above[:, :1]), above[:, :-1]], axis=1)
    run_start = above & ~prev_above
    n_peaks = jnp.sum(run_start.astype(jnp.int32), axis=1)      # [N]
    w = jnp.where(above, energy, 0.0)

    # the boundary cumsum rides the SAME associative scan as the
    # compensated (e, eb) pairs, as a third channel: TwoSum of exact
    # integers (counts <= B < 2^24) keeps hi exact and lo zero, so the
    # channel equals a plain int cumsum while costing one scan, not two
    cs_hi, cs_lo = _comp_cumsum(
        jnp.stack(
            [w, w * b_idx[None], run_start.astype(jnp.float32)], axis=-1
        ),
        axis=1,
    )
    vals_cs = jnp.concatenate(
        [cs_hi[..., :2], cs_lo[..., :2]], axis=-1
    )  # [N, B, 4] = (e, eb) hi | lo

    # boundary compaction WITHOUT the two [N, B] sorts: boundary band
    # positions are monotone in run order, so the s-th start position is
    # itself a rank count over the inclusive boundary cumsum —
    # start_pos[s] = #(b : cum_starts[b] <= s) — which rides the same
    # 0/1 bf16 einsum as the searchsorted below (exact integers).
    # Pad slots (s >= n_peaks) come back ``bands`` where the sort's
    # sentinel gave bands+1: both boundary reads then land on in-range
    # rows instead of returning 0, but every consumer masks those slots
    # (center/out_bin via ``valid``, ranks clip to cap < n_peaks), so
    # valid outputs are bit-identical to the sort form (pinned by
    # tests/test_spectral.py's delegation paths + the golden matrix).
    t_sl = next((t for t in (64, 32, 16, 8) if slots % t == 0), t_blk)
    c_start = cs_hi[..., 2].astype(jnp.int32)
    start_pos = _count_leq_blocked(c_start, slots, t_sl)
    # ONE K=slots boundary gather, at starts-1 only: every band in the
    # gap (end_pos[s], start_pos[s+1]) has above == False, so w == 0 and
    # the (e, eb) cumsum channels are BITWISE constant across the gap
    # (TwoSum pairs absorb exact zeros exactly) — hence
    # cs[end_pos[s]] == cs[start_pos[s+1] - 1], and the last valid run's
    # end (like every pad slot, whose start_pos sentinel is ``bands``)
    # reads the free total cs[B-1].  The former K=2*slots two-sided
    # gather, its end_pos rank count, and c_end all drop out; valid-slot
    # outputs are bit-identical (run gaps are >= 1 band by maximality).
    gs = block_gather(
        vals_cs, (start_pos - 1).astype(jnp.float32),
        t=t_blk, chunk=8, int_pos=True)                         # [N, s, 4]
    total = jnp.concatenate(
        [cs_hi[:, -1, :2], cs_lo[:, -1, :2]], axis=-1)[:, None]  # [N, 1, 4]
    ge = jnp.concatenate([gs[:, 1:], total], axis=1)
    sum_e = (ge[..., 0] - gs[..., 0]) + (ge[..., 2] - gs[..., 2])
    sum_eb = (ge[..., 1] - gs[..., 1]) + (ge[..., 3] - gs[..., 3])

    valid = jnp.arange(slots)[None] < n_peaks[:, None]          # [N, s]
    center = jnp.where(valid, sum_eb / jnp.maximum(sum_e, 1e-30), 0.0)
    f_in = (center + 0.5) / fft
    f_out = jnp.where(
        f_in > limit[:, None],
        f_in + (mult[:, None] - 1.0) * limit[:, None],
        f_in * mult[:, None],
    )
    out_bin = f_out * fft - 0.5
    out_sorted = jnp.where(valid, out_bin, jnp.inf)             # [N, s]

    # idx[b] = #(out_sorted <= b).  For integer b this equals #(u <= b)
    # with u = clip(ceil(out_sorted), 0, B) (invalid slots: inf -> B,
    # counted nowhere).  Decompose b = kk*t + r block-wise so the count
    # rides one 0/1 matmul instead of a [N, s, B] elementwise compare-sum
    # (benchmarks/profile_peaks.py times both):
    #     idx[kk*t + r] = #(u//t < kk)  +  #(u//t == kk  and  u%t <= r)
    # where the second term is einsum_s A[s,kk] * R[s,r] with 0/1 operands
    # A = (u//t == kk), R = (u%t <= r) — exact in bf16, f32-accumulated,
    # so every count is the exact integer and idx is value-identical.
    # the count's block size is independent of the gather t (the gather
    # wants tiny blocks, the count wants a lane-sized minor output dim)
    t_cnt = next((t for t in (64, 32, 16, 8) if bands % t == 0), t_blk)
    u = jnp.clip(jnp.ceil(out_sorted), 0.0, float(bands)).astype(jnp.int32)
    idx = _count_leq_blocked(u, bands, t_cnt)                   # [N, B]

    has = n_peaks > 0
    cap = jnp.maximum(n_peaks - 1, 0)[:, None]
    i_p = jnp.clip(idx - 1, 0, cap)
    i_q = jnp.clip(idx, 0, cap)
    vals = jnp.stack([center, out_bin], axis=-1)                # [N, s, 2]
    # Halved rank lookup (the window gather's shifted-payload trick):
    # i_q == i_p + 1 exactly when 0 < idx <= cap, and i_q == i_p on every
    # clip edge (idx <= 0 pins both to 0; idx > cap pins both to cap), so
    # ONE K=B gather whose general path reads both taps of the SAME
    # one-hot replaces the K=2B two-sided int_pos gather — the one-hot
    # build was the dominant peaks cost (mask generation).
    # return_taps keeps the chunk bodies pure 0/1 copies (FMA hazard);
    # no weighted combine is needed: i_p is always in [0, cap] so the
    # lower tap IS the row (w0 == 1), and where i_q == i_p the upper tap
    # is replaced by the lower — bit-identical to gathering at i_q, even
    # at the never-consumed non-`interior` bands.
    ga, gb, _w0, _w1 = block_gather(
        vals, i_p.astype(jnp.float32), t=t_blk, chunk=8,
        return_taps=True, layout="kmin")                        # [N, B, 2] x2
    g_q = jnp.where((i_q == i_p)[..., None], ga, gb)
    p_in, p_out = ga[..., 0], ga[..., 1]
    q_in, q_out = g_q[..., 0], g_q[..., 1]
    interior = (idx > 0) & (idx < n_peaks[:, None])
    a_in = jnp.where(idx <= 0, center[:, :1], p_in)
    a_out = jnp.where(idx <= 0, out_bin[:, :1], p_out)
    span = q_out - p_out
    safe_span = jnp.where(jnp.abs(span) > 1e-30, span, 1.0)
    t = (b_idx[None] - p_out) / safe_span
    dd = (q_in - p_in) - span
    ib_mid = (p_in - p_out) + b_idx[None] + t * t * (3.0 - 2.0 * t) * dd
    gr_mid = 1.0 + 6.0 * t * (1.0 - t) * dd / safe_span
    ib_ext = (a_in - a_out) + b_idx[None]
    input_bin = jnp.where(interior, ib_mid, ib_ext)
    grad = jnp.where(interior, gr_mid, 1.0)
    input_bin = jnp.where(has[:, None], input_bin, b_idx[None])
    grad = jnp.where(has[:, None], grad, 1.0)
    return input_bin, grad


# the blob's epsilon constant in the formant ratio (reint 0x0DA24260)
_FORMANT_TINY = float(np.frombuffer(np.uint32(228737632).tobytes(), np.float32)[0])


def _formant_f0(env_energy: jnp.ndarray, value_ema, weighted_ema, update):
    """Auto f0 smoothing width (formantBase == 0): the blob's sequential
    top-3 peak tracker over the energy envelope, two harmonic folds, and
    1/16-coefficient EMA trackers (decoded at wasm2c t1038-t1086; pinned by
    pymodel._formant_width).  Returns (width, new_value_ema,
    new_weighted_ema); the EMAs only advance when ``update`` is true (the
    blob skips step 5 entirely for formant-neutral hops)."""
    pv, i5 = _formant_peak(env_energy)
    return _formant_ema(pv, i5, value_ema, weighted_ema, update)


def _formant_ema(pv, i5, value_ema, weighted_ema, update):
    """The hop-sequential tail of the auto-f0 tracker: 1/16 EMAs of the
    (folded) peak value and its energy-weighted index, advanced only when
    ``update``; width = weighted/(value + tiny)."""
    new_value = value_ema + (pv - value_ema) * jnp.float32(0.0625)
    new_weighted = weighted_ema + (
        pv * i5.astype(jnp.float32) - weighted_ema
    ) * jnp.float32(0.0625)
    new_value = jnp.where(update, new_value, value_ema)
    new_weighted = jnp.where(update, new_weighted, weighted_ema)
    width = new_weighted / (new_value + jnp.float32(_FORMANT_TINY))
    return width, new_value, new_weighted


def _formant_peak(env_energy: jnp.ndarray):
    """The hop-LOCAL part of the auto-f0 tracker: sequential top-3 peak
    scan over the envelope + the two harmonic folds.  Returns
    (peak_value f32, folded index i5 int32) — state-free, so a whole
    chunk's hops batch through it (vmap over hops x streams)."""
    b_n = env_energy.shape[0]
    e0 = env_energy[0]
    init = (e0, e0, e0, jnp.int32(0), jnp.int32(0), jnp.int32(0))
    xs = (
        env_energy[:-2],                       # env[b-1]
        env_energy[1:-1],                      # env[b]
        env_energy[2:],                        # env[b+1]
        jnp.arange(1, b_n - 1, dtype=jnp.int32),
    )

    def body(carry, x):
        e2, e5, e4, i2, i5, i4 = carry
        ep, v, en, b = x
        consider = (v >= ep) & (v > en) & (v > e4)
        c1 = e2 >= v      # new third peak only
        c2 = e5 < v       # new maximum: rotate third<-second<-max<-b
        n_e4 = jnp.where(c1, v, e2)
        n_i4 = jnp.where(c1, b, i2)
        n_e2 = jnp.where(c1, e2, jnp.where(c2, e5, v))
        n_i2 = jnp.where(c1, i2, jnp.where(c2, i5, b))
        n_e5 = jnp.where(c1 | ~c2, e5, v)
        n_i5 = jnp.where(c1 | ~c2, i5, b)
        new = (n_e2, n_e5, n_e4, n_i2, n_i5, n_i4)
        return tuple(jnp.where(consider, n, o) for n, o in zip(new, carry)), None

    (e2, e5, e4, i2, i5, i4), _ = jax.lax.scan(body, init, xs)
    peak_val = e5
    do1 = e2 > peak_val * 0.1
    d1 = jnp.abs(i5 - i2)
    fold1 = do1 & ~((d1 <= i5 // 8) | (d1 >= (i5 * 7) // 8))
    i5 = jnp.where(fold1, i5 % jnp.maximum(d1, 1), i5)
    do2 = do1 & (e4 > peak_val * 0.01)
    d2 = jnp.abs(i5 - i4)
    fold2 = do2 & ~((d2 <= i5 // 8) | (d2 >= (i5 * 7) // 8))
    i5 = jnp.where(fold2, i5 % jnp.maximum(d2, 1), i5)
    return peak_val.astype(jnp.float32), i5


def _formant_gain(
    cfg: SpectralConfig,
    energy_c: jnp.ndarray,   # [C, bands] Band.energy (pre-formant)
    state: SpectralState,
    mult, limit,             # transpose multiplier + stored tonality limit
    formant_factor, formant_compensation, formant_base,
):
    """The blob's step 5 as one vectorized pass: returns (gain [bands] to
    multiply into the per-channel energies, new_value_ema, new_weighted_ema).
    Formant-neutral params yield the exact identity gain and frozen EMAs
    (matching the blob's gate, wasm2c t173/b_174)."""
    fft = cfg.fft
    mapping = mult != 1.0
    active = (formant_factor != 1.0) | ((formant_compensation != 0.0) & mapping)
    env_e = jnp.sum(energy_c, axis=0)                       # [bands]
    auto = formant_base <= 0.0
    w_auto, new_v, new_w = _formant_f0(
        env_e, state.f_value_ema, state.f_weighted_ema, active & auto
    )
    width = jnp.where(
        auto, w_auto, (formant_base * fft - 0.5).astype(jnp.float32)
    )
    gain = _formant_gain_from_width(
        cfg, env_e, width, active, mult, limit,
        formant_factor, formant_compensation,
    )
    return gain, new_v, new_w


def _formant_gain_from_width(
    cfg: SpectralConfig, env_e, width, active, mult, limit,
    formant_factor, formant_compensation,
):
    """The hop-local tail of step 5 once the smoothing width is known:
    envelope smoothing + the (compensation-aware) frequency remap + the
    squared-ratio gain.  Batches over hops (width per hop)."""
    fft, b_n = cfg.fft, cfg.bands
    env = jnp.sqrt(env_e)
    coef = (1.0 / (width * 0.5 + 1.0)).astype(jnp.float32)
    sm, carry = _smooth_bidirectional(env, coef, jnp.zeros(()))
    sm, _ = _smooth_bidirectional(sm, coef, carry)
    freq = (jnp.arange(b_n, dtype=jnp.float32) + 0.5) / fft
    # compensation: look up in TRANSPOSE-mapped space (undoes the shift)
    fr = jnp.where(
        formant_compensation != 0.0,
        jnp.where(freq > limit, freq + (mult - 1.0) * limit, freq * mult),
        freq,
    )
    inv = 1.0 / formant_factor
    fm = inv * fr
    fm = jnp.where(fm > limit, (1.0 - formant_factor) * limit + fr, fm)
    pos = fm * fft - 0.5
    env_m = _get_fractional(sm, pos)
    env_m = jnp.where(pos < 0.0, 0.0, env_m)
    ratio = env_m / (sm + jnp.float32(_FORMANT_TINY))
    return jnp.where(active, jnp.square(ratio), 1.0)


def _get_fractional(arr: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Complex/real linear interpolation along the band axis with zeros
    outside [0, B) — the blob's getFractional.

    arr [..., B]; pos [B] — ONE position table shared by every leading
    axis (all engine call sites look up per-band positions identically
    across channels).  The lookup runs as a MAJOR-axis row gather on the
    transposed array (row gathers move contiguous rows); real and imag
    gather separately."""
    b = arr.shape[-1]
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - i0).astype(jnp.float32)          # [B]

    is_c = jnp.iscomplexobj(arr)
    planes = (
        jnp.stack([jnp.real(arr), jnp.imag(arr)], axis=0) if is_c else arr[None]
    )                                               # [P?, ..., B] real
    arr_t = jnp.moveaxis(planes, -1, 0)             # [B, P?, ...]

    def at(idx):
        ok = ((idx >= 0) & (idx < b)).astype(jnp.float32)
        v = jnp.take(arr_t, jnp.clip(idx, 0, b - 1), axis=0)  # [K, P?, ...]
        return v * ok.reshape((idx.shape[0],) + (1,) * (v.ndim - 1))

    out_t = (
        at(i0) * frac_shape((1.0 - frac), arr_t.ndim)
        + at(i0 + 1) * frac_shape(frac, arr_t.ndim)
    )
    out = jnp.moveaxis(out_t, 0, -1)                # [P?, ..., B]
    if is_c:
        return jax.lax.complex(out[0], out[1])
    return out[0]


def frac_shape(f: jnp.ndarray, ndim: int) -> jnp.ndarray:
    return f.reshape((f.shape[0],) + (1,) * (ndim - 1))


def _get_fractional_multi(arr: jnp.ndarray, pos_list) -> list:
    """getFractional at several position tables over the SAME array with one
    row gather (concatenated indices) — one gather kernel instead of K."""
    k = len(pos_list)
    out = _get_fractional(arr, jnp.concatenate(pos_list))
    return list(jnp.split(out, k, axis=-1))


def spectral_hop(
    cfg: SpectralConfig,
    state: SpectralState,
    spec_in: jnp.ndarray,    # [C, bands] complex64 — analysis at the frame
    spec_prev: jnp.ndarray,  # [C, bands] complex64 — analysis one interval back
    time_factor: jnp.ndarray,  # scalar f32 (= 1/rate in the seek-driven path)
    mult: jnp.ndarray,         # scalar f32 — frequency multiplier 2^(st/12)
    limit: jnp.ndarray,        # scalar f32 — stored tonality limit
    formant_factor=None,       # scalar f32 2^(st/12); None/1.0 = neutral
    formant_compensation=None,  # scalar 0/1
    formant_base=None,          # scalar f32 normalized freq; <=0 = auto f0
):
    """One hop of the blob's processSpectrum.  Returns (state, out [C, B]).

    Formant processing (step 5) runs only when ``cfg.formants`` compiled it
    in AND formant params were passed; neutral params then reproduce the
    blob's skip exactly (identity gain, frozen trackers)."""
    chain, carried = _chain_inputs(
        cfg, state, spec_in, spec_prev, time_factor, mult, limit,
        formant_factor, formant_compensation, formant_base,
    )
    out = _band_chain_scan(cfg, chain)
    new_rng, new_fv, new_fw, pred_energy = carried
    return SpectralState(
        prev_output=out, prev_pred_energy=pred_energy, rng=new_rng,
        f_value_ema=new_fv, f_weighted_ema=new_fw,
    ), out


def _chain_inputs(
    cfg: SpectralConfig,
    state: SpectralState,
    spec_in: jnp.ndarray,
    spec_prev: jnp.ndarray,
    time_factor, mult, limit,
    formant_factor=None, formant_compensation=None, formant_base=None,
):
    """Steps 3-6 + the step-7 gathers: everything before the sequential
    band chain.  Returns ``(chain_inputs, (new_rng, new_fv, new_fw,
    pred_energy))`` where chain_inputs = (d1, d2, u12, pe_mc, pi_mc, mc,
    lock, pred_energy, pred_input) — the exact operand set of the chain
    (consumed by :func:`_band_chain_scan` or the batched Pallas kernel)."""
    c_n, b_n = cfg.channels, cfg.bands
    fft, interval, long_step = cfg.fft, cfg.interval, cfg.long_step
    b_idx = jnp.arange(b_n, dtype=jnp.float32)

    # -- step 3: re-reference carried spectra to the new frame position ----
    rot = _unit_phase(2.0 * np.pi * (np.arange(b_n) + 0.5) * interval / fft)
    p_out = state.prev_output * rot[None]
    spec_prev = spec_prev * rot[None]

    # -- step 4: frequency map ---------------------------------------------
    energy_c = jnp.square(jnp.abs(spec_in))          # [C, B] Band.energy
    energy = jnp.sum(energy_c, axis=0)               # [B]
    coef = 1.0 / (0.5 * (fft / interval) + 1.0)
    sm, carry = _smooth_bidirectional(energy, coef, jnp.zeros(()))
    sm, _ = _smooth_bidirectional(sm, coef, carry)
    ib_m, gr_m = _find_peaks_map(energy, sm, mult, limit, b_n, fft)
    mapping = mult != 1.0
    input_bin = jnp.where(mapping, ib_m, b_idx)
    grad = jnp.where(mapping, gr_m, 1.0)

    # -- step 5: formant processing (blob gate: factor != 1, or
    # compensation and mapping — neutral params are an exact no-op) --------
    if cfg.formants and formant_factor is not None:
        fgain, new_fv, new_fw = _formant_gain(
            cfg, energy_c, state, mult, limit,
            formant_factor, formant_compensation, formant_base,
        )
        energy_c = energy_c * fgain[None]
    else:
        new_fv, new_fw = state.f_value_ema, state.f_weighted_ema

    # -- step 6: predictions + time-prediction ------------------------------
    # (the five spec_in lookups — map position + the four step-7 gather
    # families — run as ONE concatenated row gather further below)
    d_down, d_up, new_rng = _minstd_steps(state.rng, time_factor, b_n)
    zf = jnp.zeros((1,), jnp.float32)
    us_pos = jnp.concatenate([input_bin[1:], zf]) - d_up
    ul_pos = (
        jnp.concatenate([input_bin[long_step:], jnp.zeros((long_step,), jnp.float32)])
        - d_up * long_step
    )
    pred_input, down_s, down_l, us_g, ul_g = _get_fractional_multi(
        spec_in,
        [input_bin, input_bin - d_down, input_bin - d_down * long_step,
         us_pos, ul_pos],
    )
    pred_energy = _get_fractional(energy_c, input_bin) * jnp.maximum(grad, 0.0)[None]
    prev_interp = _get_fractional(spec_prev, input_bin)
    tw = pred_input * jnp.conj(prev_interp)
    # the prediction buffer is PER CHANNEL (stereo memory dump at 6660):
    # each channel's denominator reads its own slot before overwriting it,
    # i.e. sees max(own energy this hop, own energy last hop)
    den = (jnp.maximum(pred_energy, state.prev_pred_energy) + EPS).astype(
        jnp.complex64
    )
    timepred = p_out * tw / den                       # [C, B]

    # -- step 7: sequential Gauss-Seidel over bands --------------------------
    # Vertical time steps: deterministic clamp at tf <= 2, the blob's
    # MINSTD-random per-band draws at tf > 2 (four distinct gather-position
    # families; with the deterministic step they collapse to the shared
    # shifted arrays us[b] == ds[b+1] etc.).
    mc = jnp.argmax(pred_energy, axis=0)              # [B] leading channel

    onehot_mc = (jnp.arange(c_n)[:, None] == mc[None, :])  # [C, B] bool

    def sel(arr):  # arr [C, B] -> [B] at channel mc[b] (complex-gather-free)
        return jnp.sum(arr * onehot_mc.astype(jnp.float32), axis=0)

    def shift1(a):
        return jnp.concatenate([a[:, 1:], jnp.zeros((c_n, 1), a.dtype)], axis=1)

    def shiftL(a):
        return jnp.concatenate(
            [a[:, long_step:], jnp.zeros((c_n, long_step), a.dtype)], axis=1
        )

    d1 = sel(pred_input * jnp.conj(down_s))           # lower, short
    d2 = sel(pred_input * jnp.conj(down_l))           # lower, long
    u1 = sel(shift1(timepred) * jnp.conj(shift1(pred_input) * jnp.conj(us_g)))
    u2 = sel(shiftL(timepred) * jnp.conj(shiftL(pred_input) * jnp.conj(ul_g)))
    pe_mc = sel(pred_energy)
    pi_mc = sel(pred_input)
    # cross-channel lock factors conj(tw_c) = conj(pi_mc * conj(pi_c))
    lock = jnp.conj(pi_mc[None] * jnp.conj(pred_input))  # [C, B]

    chain = (d1, d2, u1 + u2, pe_mc, pi_mc, mc, lock, pred_energy, pred_input)
    return chain, (new_rng, new_fv, new_fw, pred_energy)


@functools.lru_cache(maxsize=32)
def _minstd_hop_powers(n_draws: int, n_hops: int) -> np.ndarray:
    """[n_hops + 1] uint32: (48271^n_draws)^h mod (2^31-1) for h = 0..H —
    the per-hop MINSTD seed advance, precomputed so a whole chunk's draw
    streams vectorize (seed_h = s * (a^n)^h)."""
    a_n = pow(MINSTD_A, n_draws, MINSTD_M)
    out = np.empty(n_hops + 1, np.uint32)
    p = 1
    for h in range(n_hops + 1):
        out[h] = p
        p = (p * a_n) % MINSTD_M
    return out


def _hop_pre_gather(
    cfg: SpectralConfig,
    spec_in: jnp.ndarray,    # [C, bands] complex64 — analysis at the frame
    spec_prev: jnp.ndarray,  # [C, bands] complex64 — one interval back
    seed: jnp.ndarray,       # [] uint32 — this hop's MINSTD seed
    time_factor, mult, limit,
    fgain: jnp.ndarray | None = None,  # [bands] step-5 gain (or None)
    peaks: tuple | None = None,  # precomputed (ib_m, gr_m) from the batched
                                 # peaks map (bit-exact; see _hop_inputs_hoisted)
    minstd_seq: jnp.ndarray | None = None,  # [2B-2] precomputed draw stream
):
    """Steps 3-6 of :func:`_chain_inputs` up to (but excluding) the row
    gathers: smoothers, peak map, MINSTD draws, gather POSITIONS.  Returns
    ``(spec_prev_rot, energy_c, input_bin, grad, pos5)`` where ``pos5`` is
    the concatenated five-family position table ([5B]; same concat order as
    `_get_fractional_multi` in `_chain_inputs`, so gathering `spec_in` at
    `pos5` is op-identical to the pinned path)."""
    b_n = cfg.bands
    fft, interval, long_step = cfg.fft, cfg.interval, cfg.long_step
    b_idx = jnp.arange(b_n, dtype=jnp.float32)

    # -- step 3 (hop-local half): re-reference the previous-interval
    # analysis; the carried prev_output rotates in the sequential pass ----
    rot = _unit_phase(2.0 * np.pi * (np.arange(b_n) + 0.5) * interval / fft)
    spec_prev = spec_prev * rot[None]

    # -- step 4: frequency map ---------------------------------------------
    energy_c = jnp.square(jnp.abs(spec_in))          # [C, B] Band.energy
    if peaks is None:
        energy = jnp.sum(energy_c, axis=0)           # [B]
        coef = 1.0 / (0.5 * (fft / interval) + 1.0)
        sm, carry = _smooth_bidirectional(energy, coef, jnp.zeros(()))
        sm, _ = _smooth_bidirectional(sm, coef, carry)
        ib_m, gr_m = _find_peaks_map(energy, sm, mult, limit, b_n, fft)
    else:
        ib_m, gr_m = peaks
    mapping = mult != 1.0
    input_bin = jnp.where(mapping, ib_m, b_idx)
    grad = jnp.where(mapping, gr_m, 1.0)

    # -- step 5: formant gain precomputed by the caller --------------------
    if fgain is not None:
        energy_c = energy_c * fgain[None]

    # -- step 6: gather positions (minus the state-coupled time-twist) -----
    d_down, d_up, _ = _minstd_steps(seed, time_factor, b_n, seq=minstd_seq)
    zf = jnp.zeros((1,), jnp.float32)
    us_pos = jnp.concatenate([input_bin[1:], zf]) - d_up
    ul_pos = (
        jnp.concatenate([input_bin[long_step:], jnp.zeros((long_step,), jnp.float32)])
        - d_up * long_step
    )
    pos5 = jnp.concatenate(
        [input_bin, input_bin - d_down, input_bin - d_down * long_step,
         us_pos, ul_pos]
    )
    return spec_prev, energy_c, input_bin, grad, pos5


def _hop_post_gather(
    cfg: SpectralConfig,
    five: jnp.ndarray,         # [C, 5B] complex — spec_in at the 5 tables
    pe_raw: jnp.ndarray,       # [C, B] float32 — energy_c at input_bin
    prev_interp: jnp.ndarray,  # [C, B] complex — rotated prev at input_bin
    grad: jnp.ndarray,         # [B]
):
    """Step-7 operand assembly from gathered rows (state-free factors)."""
    c_n, long_step = cfg.channels, cfg.long_step
    pred_input, down_s, down_l, us_g, ul_g = jnp.split(five, 5, axis=-1)
    pred_energy = pe_raw * jnp.maximum(grad, 0.0)[None]
    tw = pred_input * jnp.conj(prev_interp)           # [C, B]

    mc = jnp.argmax(pred_energy, axis=0)              # [B] leading channel
    onehot_mc = (jnp.arange(c_n)[:, None] == mc[None, :])  # [C, B] bool
    oh_f = onehot_mc.astype(jnp.float32)

    def sel(arr):
        return jnp.sum(arr * oh_f, axis=0)

    def shift1(a):
        return jnp.concatenate([a[:, 1:], jnp.zeros((c_n, 1), a.dtype)], axis=1)

    def shiftL(a):
        return jnp.concatenate(
            [a[:, long_step:], jnp.zeros((c_n, long_step), a.dtype)], axis=1
        )

    d1 = sel(pred_input * jnp.conj(down_s))           # lower, short
    d2 = sel(pred_input * jnp.conj(down_l))           # lower, long
    # u12 in the sequential pass is sel(shift1(timepred) * K1) +
    # sel(shiftL(timepred) * K2); fold the onehot into the state-free
    # factors (exact: onehot is literal 0/1)
    k1 = jnp.conj(shift1(pred_input) * jnp.conj(us_g)) * oh_f
    k2 = jnp.conj(shiftL(pred_input) * jnp.conj(ul_g)) * oh_f
    pe_mc = sel(pred_energy)
    pi_mc = sel(pred_input)
    lock = jnp.conj(pi_mc[None] * jnp.conj(pred_input))  # [C, B]

    return dict(
        d1=d1, d2=d2, k1=k1, k2=k2, tw=tw, pe_mc=pe_mc, pi_mc=pi_mc,
        mc=mc, lock=lock, pred_energy=pred_energy, pred_input=pred_input,
    )


def _hop_local_inputs(
    cfg: SpectralConfig,
    spec_in: jnp.ndarray,    # [C, bands] complex64 — analysis at the frame
    spec_prev: jnp.ndarray,  # [C, bands] complex64 — one interval back
    seed: jnp.ndarray,       # [] uint32 — this hop's MINSTD seed
    time_factor, mult, limit,
    fgain: jnp.ndarray | None = None,  # [bands] step-5 gain (or None)
):
    """The hop-LOCAL part of steps 3-7 of :func:`_chain_inputs`: everything
    that does not depend on the carried spectra.  Identical math/op-order to
    `_chain_inputs` (the hop-exact pinned path) — only the two
    state-coupled products (``timepred`` and the ``u12`` selections) are
    deferred to the light sequential pass, their state-free factors
    returned here (``tw``, ``k1``, ``k2``).  This is what lets a serving
    chunk precompute ALL hops' smoothers/peak-maps/gathers in one batched
    pass (vmap over hops x streams) instead of once per scan iteration.

    Split into :func:`_hop_pre_gather` (positions) + row gathers +
    :func:`_hop_post_gather` (operand assembly) so the serving path can
    swap the gathers for the one-hot block-matmul form
    (``ops.blockgather``) without duplicating any surrounding math."""
    spec_prev_rot, energy_c, input_bin, grad, pos5 = _hop_pre_gather(
        cfg, spec_in, spec_prev, seed, time_factor, mult, limit, fgain
    )
    five = _get_fractional(spec_in, pos5)             # [C, 5B]
    pe_raw = _get_fractional(energy_c, input_bin)
    prev_interp = _get_fractional(spec_prev_rot, input_bin)
    return _hop_post_gather(cfg, five, pe_raw, prev_interp, grad)


def _hop_inputs_hoisted(
    cfg: SpectralConfig,
    cur: jnp.ndarray,          # [H, S, C, bands] complex64
    prev: jnp.ndarray,         # [H, S, C, bands] complex64
    seeds: jnp.ndarray,        # [H, S] uint32
    time_factor, mult, limit,  # [S]
    fgain=None,                # [H, S, bands] or None
):
    """All hops' chain inputs with the row gathers hoisted out of the vmap
    into one-hot block matmuls (``ops.blockgather.block_gather``, bit-exact
    vs `_get_fractional` — 0/1 weights copy f32 values under HIGHEST
    precision; benchmarks/profile_chain_inputs.py times the stage);
    positions are NOT
    monotone in the kiosk MINSTD regime so the fast engine's banded
    interpolation does not apply."""
    from bauklank.ops.blockgather import block_gather

    h, s_n, c_n, b_n = cur.shape
    t_blk = _peaks_block_t(b_n)
    if t_blk is None:
        # odd band grid: keep the row-gather form under vmap
        if fgain is None:
            f = jax.vmap(
                jax.vmap(
                    lambda si, sp, sd, t, m, l: _hop_local_inputs(
                        cfg, si, sp, sd, t, m, l
                    )
                ),
                in_axes=(0, 0, 0, None, None, None),
            )
            return f(cur, prev, seeds, time_factor, mult, limit)
        f = jax.vmap(
            jax.vmap(
                lambda si, sp, sd, t, m, l, g: _hop_local_inputs(
                    cfg, si, sp, sd, t, m, l, g
                )
            ),
            in_axes=(0, 0, 0, None, None, None, 0),
        )
        return f(cur, prev, seeds, time_factor, mult, limit, fgain)

    n = h * s_n

    # peak maps for ALL hops in one batched pass, rank lookups as one-hot
    # block matmuls (_find_peaks_map_batched) — as 4 per-example [B]->[B]
    # gathers under the vmap they cost one small gather per example.
    # Identical math to the in-vmap form: the smoothers/scatters batch
    # elementwise, so every output stays maxdiff==0 vs _hop_local_inputs.
    energy_all = jnp.sum(jnp.square(jnp.abs(cur)), axis=2)      # [H, S, B]
    coef = 1.0 / (0.5 * (cfg.fft / cfg.interval) + 1.0)
    e_flat = energy_all.reshape(n, b_n)
    sm, carry = _smooth_bidirectional(e_flat, coef, jnp.zeros((n,)))
    sm, _ = _smooth_bidirectional(sm, coef, carry)
    mult_n = jnp.broadcast_to(mult[None], (h, s_n)).reshape(n)
    limit_n = jnp.broadcast_to(limit[None], (h, s_n)).reshape(n)
    ib_m, gr_m = _find_peaks_map_batched(
        e_flat, sm, mult_n, limit_n, b_n, cfg.fft, t_blk)
    peaks = (ib_m.reshape(h, s_n, b_n), gr_m.reshape(h, s_n, b_n))

    # MINSTD draw streams for all hops, gated behind the regime cond: at
    # tf <= 2 everywhere (rate >= 0.5, the BASELINE serving matrix) every
    # draw is discarded by _minstd_steps' ``use`` select, so the [N, 2B-2]
    # modmul batch is replaced by a dummy
    # stream.  Exact by construction: the cond branches hold only integer
    # modmuls (nothing for XLA to FMA-contract); the f32 rounding ops stay
    # at top level inside _minstd_steps, identical to the pinned path.
    n_draws = 2 * b_n - 2
    pows = jnp.asarray(_minstd_powers(n_draws))
    seeds_n = seeds.reshape(n)

    def _rand_seq(_):
        return _modmul31(seeds_n[:, None], pows[None, :])    # [N, 2B-2]

    def _dummy_seq(_):
        return jnp.ones((n, n_draws), jnp.uint32)

    seq_n = jax.lax.cond(
        jnp.any(time_factor > 2.0), _rand_seq, _dummy_seq, None
    ).reshape(h, s_n, n_draws)

    if fgain is None:
        pre = jax.vmap(
            jax.vmap(
                lambda si, sp, sd, t, m, l, pk, sq: _hop_pre_gather(
                    cfg, si, sp, sd, t, m, l, peaks=pk, minstd_seq=sq
                )
            ),
            in_axes=(0, 0, 0, None, None, None, 0, 0),
        )
        spec_prev_rot, energy_c, input_bin, grad, pos5 = pre(
            cur, prev, seeds, time_factor, mult, limit, peaks, seq_n
        )
    else:
        pre = jax.vmap(
            jax.vmap(
                lambda si, sp, sd, t, m, l, g, pk, sq: _hop_pre_gather(
                    cfg, si, sp, sd, t, m, l, g, peaks=pk, minstd_seq=sq
                )
            ),
            in_axes=(0, 0, 0, None, None, None, 0, 0, 0),
        )
        spec_prev_rot, energy_c, input_bin, grad, pos5 = pre(
            cur, prev, seeds, time_factor, mult, limit, fgain, peaks, seq_n
        )

    def planes_of(z):  # [N, C, B] complex -> [N, B, 2C] (re/im interleaved)
        p = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)   # [N, C, B, 2]
        return jnp.moveaxis(p, 1, 2).reshape(n, b_n, 2 * c_n)

    def complex_of(p, k):  # [N, K, 2C] -> [H, S, C, K]
        q = p.reshape(n, k, c_n, 2)
        z = jax.lax.complex(q[..., 0], q[..., 1])            # [N, K, C]
        return jnp.moveaxis(z, -1, 1).reshape(h, s_n, c_n, k)

    # 1+2: spec_in at the five-family table and prev/energy at input_bin.
    # Deterministic-step regime (every stream at tf <= 2, i.e. rate >=
    # 0.5 — the BASELINE matrix): all six families read within a 12-band
    # window of input_bin (ops/windowgather).  MINSTD regimes keep the
    # generic block-matmul gathers.
    spec_p = planes_of(cur.reshape(n, c_n, b_n))             # [N, B, 2C]
    prev_p = planes_of(spec_prev_rot.reshape(n, c_n, b_n))
    en_p = jnp.moveaxis(energy_c.reshape(n, c_n, b_n), 1, 2)  # [N, B, C]
    pos5_n = pos5.reshape(n, 5 * b_n)
    ib_n = input_bin.reshape(n, b_n)

    # both branches return UNCOMBINED (ga, gb, w0, w1) per gather and the
    # weighted combine runs once below, OUTSIDE the cond: XLA FMA-
    # contracts mul+add inside cond branches exactly like inside lax.map
    # bodies, which would break the maxdiff==0 contract vs
    # `_get_fractional` (ops/blockgather.py taps_chunk).
    def slow_gathers(_):
        ga5, gb5, w05, w15 = block_gather(
            spec_p, pos5_n, t=t_blk, chunk=8, return_taps=True)
        comb = jnp.concatenate([prev_p, en_p], axis=-1)      # [N, B, 3C]
        gac, gbc, w0c, w1c = block_gather(
            comb, ib_n, t=t_blk, chunk=8, return_taps=True)
        return ga5, gb5, w05, w15, gac, gbc, w0c, w1c

    def _tap_weights(pos):
        """block_gather's weight formula (ops/blockgather.py:80-87);
        mul-of-sub only — no mul+add for XLA to FMA-contract, so safe
        inside a cond branch."""
        i0 = jnp.floor(pos).astype(jnp.int32)
        frac = (pos - i0).astype(jnp.float32)
        ok0 = ((i0 >= 0) & (i0 < b_n)).astype(jnp.float32)
        ok1 = ((i0 + 1 >= 0) & (i0 + 1 < b_n)).astype(jnp.float32)
        return ok0 * (1.0 - frac), ok1 * frac

    # Default deterministic-regime fast path: the shared-window gather
    # (ops/windowgather — batched einsums, 2.6x fewer
    # selection MACs and ~5x less mask generation than the generic
    # per-position one-hots).  BAUKLANK_WINGATHER=0 falls back to the
    # generic blockgather path in every regime.
    from bauklank.ops.windowgather import window_gather_taps, window_t1

    t1_win = window_t1(b_n, cfg.long_step)
    if os.environ.get("BAUKLANK_WINGATHER", "1") in ("0", "false", "off"):
        t1_win = None

    if t1_win is not None:
        # Plane-major epilogue: taps come back [N, P, K] (bands on
        # LANES), the weighted combine broadcasts the [N, K] weights on
        # the plane axis, and the complex re-pack below reads the
        # (c*2 + reim) plane rows directly — no post-combine relayout
        # (the downstream [H, S, C, K] layout is band-minor already).
        # Per-element arithmetic is identical to the band-major form
        # (hoisted micro-check maxdiff==0, tests/test_spectral.py), and
        # it removes the 32x-padded [N, 5B, P<=4]-minor combine buffer
        # of the band-major form.
        def win_gathers(_):
            stepc = jnp.broadcast_to(
                jnp.clip(time_factor, 0.5, 2.0)[None, :], (h, s_n)
            ).reshape(n)
            ga5, gb5, gac, gbc = window_gather_taps(
                spec_p, prev_p, en_p, ib_n, pos5_n, stepc,
                long_step=cfg.long_step, t1=t1_win, chunk=8,
                out_layout="pm")
            w05, w15 = _tap_weights(pos5_n)
            w0c, w1c = _tap_weights(ib_n)
            return ga5, gb5, w05, w15, gac, gbc, w0c, w1c

        def slow_gathers_pm(_):
            ga5, gb5, w05, w15, gac, gbc, w0c, w1c = slow_gathers(None)
            tr = lambda x: jnp.transpose(x, (0, 2, 1))
            return tr(ga5), tr(gb5), w05, w15, tr(gac), tr(gbc), w0c, w1c

        ga5, gb5, w05, w15, gac, gbc, w0c, w1c = jax.lax.cond(
            jnp.all(time_factor <= 2.0), win_gathers, slow_gathers_pm,
            None)
        five_pm = ga5 * w05[:, None, :] + gb5 * w15[:, None, :]
        g1_pm = gac * w0c[:, None, :] + gbc * w1c[:, None, :]

        def complex_of_pm(p, k):  # [N, 2C', K] plane rows c*2 + reim
            q = p.reshape(n, -1, 2, k)
            z = jax.lax.complex(q[:, :, 0], q[:, :, 1])      # [N, C', K]
            return z.reshape(h, s_n, -1, k)

        five = complex_of_pm(five_pm, 5 * b_n)               # [H, S, C, 5B]
        prev_interp = complex_of_pm(g1_pm[:, : 2 * c_n], b_n)
        pe_raw = g1_pm[:, 2 * c_n:].reshape(h, s_n, c_n, b_n)

        post = jax.vmap(
            jax.vmap(
                lambda f5, pe, pv, gr: _hop_post_gather(cfg, f5, pe, pv, gr)
            )
        )
        return post(five, pe_raw, prev_interp, grad)
    else:
        ga5, gb5, w05, w15, gac, gbc, w0c, w1c = slow_gathers(None)
    five_p = ga5 * w05[..., None] + gb5 * w15[..., None]
    g1 = gac * w0c[..., None] + gbc * w1c[..., None]

    five = complex_of(five_p, 5 * b_n)                       # [H, S, C, 5B]
    prev_interp = complex_of(g1[..., : 2 * c_n], b_n)        # [H, S, C, B]
    pe_raw = jnp.moveaxis(g1[..., 2 * c_n:], -1, 1).reshape(
        h, s_n, c_n, b_n
    )

    post = jax.vmap(
        jax.vmap(
            lambda f5, pe, pv, gr: _hop_post_gather(cfg, f5, pe, pv, gr)
        )
    )
    return post(five, pe_raw, prev_interp, grad)


def chain_inputs_hops(
    cfg: SpectralConfig,
    state: SpectralState,      # leading [S] axis on every leaf
    cur: jnp.ndarray,          # [H, S, C, bands] complex64
    prev: jnp.ndarray,         # [H, S, C, bands] complex64
    time_factor, mult, limit,  # [S]
    formant_factor=None, formant_compensation=None, formant_base=None,
):
    """Precompute the chain inputs of ALL hops of a serving chunk in one
    batched pass: the smoothing scans, peak maps,
    MINSTD draw streams, row gathers, and the formant chain are hop-local
    (state-free) once the MINSTD seeds (a data-independent geometric
    sequence), the formant EMAs (a scalar linear recurrence), and the
    stale-prediction denominators (a one-hop shift of the hop-local
    pred_energy) are resolved up front.  Returns ``(xs, carried)``:
    ``xs`` a dict of [H, S, ...] operand tensors (including ``den``),
    ``carried = (rng_final, f_value_ema, f_weighted_ema)``.
    """
    h = cur.shape[0]
    b_n = cfg.bands
    n_draws = 2 * b_n - 2
    hop_pows = jnp.asarray(_minstd_hop_powers(n_draws, h))       # [H+1]
    seeds_all = _modmul31(state.rng[None, :], hop_pows[:, None])  # [H+1, S]
    use = time_factor > 2.0
    seeds = jnp.where(use[None, :], seeds_all[:h], state.rng[None, :])
    rng_final = jnp.where(use, seeds_all[h], state.rng)

    fgain = None
    fv, fw = state.f_value_ema, state.f_weighted_ema
    if cfg.formants and formant_factor is not None:
        mapping = mult != 1.0
        active = (formant_factor != 1.0) | (
            (formant_compensation != 0.0) & mapping
        )                                                         # [S]
        env_e = jnp.sum(jnp.square(jnp.abs(cur)), axis=2)         # [H, S, B]
        auto = formant_base <= 0.0
        pv, i5 = jax.vmap(jax.vmap(_formant_peak))(env_e)         # [H, S]
        upd = active & auto

        def ema_body(carry, x):
            v, w = carry
            wid, v2, w2 = _formant_ema(x[0], x[1], v, w, upd)
            return (v2, w2), wid

        (fv, fw), w_auto = jax.lax.scan(ema_body, (fv, fw), (pv, i5))
        width = jnp.where(
            auto[None, :], w_auto,
            (formant_base * cfg.fft - 0.5).astype(jnp.float32)[None, :],
        )                                                         # [H, S]
        fgain = jax.vmap(
            lambda ee, wd, a, m, l, ff, fc: _formant_gain_from_width(
                cfg, ee, wd, a, m, l, ff, fc
            ),
            in_axes=(1, 1, 0, 0, 0, 0, 0), out_axes=1,
        )(env_e, width, active, mult, limit,
          formant_factor, formant_compensation)                   # [H, S, B]

    xs = _hop_inputs_hoisted(cfg, cur, prev, seeds, time_factor, mult, limit, fgain)

    # stale prediction denominators: hop h sees max(pe_h, pe_{h-1}) + EPS
    # (kept real here; the sequential pass casts to complex64 on device,
    # reproducing the original's complex division bit-for-bit)
    pe = xs["pred_energy"]                                        # [H, S, C, B]
    prev_pe = jnp.concatenate([state.prev_pred_energy[None], pe[:-1]], axis=0)
    xs["den"] = jnp.maximum(pe, prev_pe) + EPS
    return xs, (rng_final, fv, fw)


def _band_chain_scan(cfg: SpectralConfig, chain) -> jnp.ndarray:
    """The sequential Gauss-Seidel chain as one lax.scan (single-stream
    path; the batched pool path uses the Pallas kernel instead)."""
    c_n, b_n, long_step = cfg.channels, cfg.bands, cfg.long_step
    d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input = chain

    has_lower_s = jnp.arange(b_n) >= 1
    has_lower_l = jnp.arange(b_n) >= long_step

    # every complex operand rides the scan as a stacked [..., 2] float32
    # pair and is reassembled with lax.complex inside the body.
    def ri(z):  # complex [...] -> float32 [..., 2]
        return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)

    def cx(a):  # float32 [..., 2] -> complex
        return jax.lax.complex(a[..., 0], a[..., 1])

    xs = (
        ri(d1), ri(d2), ri(u12), pe_mc, ri(pi_mc), mc,
        ri(lock.T), pred_energy.T, ri(pred_input.T),   # [B, C(, 2)]
        has_lower_s, has_lower_l,
    )

    def body(ring, x):
        d1r, d2r, ur, peb, pir, mcb, lockr, pec, picr, hs, hl = x
        d1b, d2b, ub, pib = cx(d1r), cx(d2r), cx(ur), cx(pir)
        lockb, pic = cx(lockr), cx(picr)
        # ring: [long_step, C, 2] finalized outputs of the last bands
        oh = (jnp.arange(c_n) == mcb).astype(jnp.float32)
        out_m1 = jnp.sum(cx(ring[-1]) * oh)  # band b-1, leader channel
        out_mL = jnp.sum(cx(ring[0]) * oh)   # band b-long_step
        ph = ub
        ph = ph + jnp.where(hs, out_m1 * d1b, 0.0)
        ph = ph + jnp.where(hl, out_mL * d2b, 0.0)
        p2 = jnp.square(jnp.abs(ph))
        tiny = p2 <= EPS
        ph = jnp.where(tiny, pib, ph)
        p2 = jnp.where(tiny, jnp.square(jnp.abs(pib)) + EPS, p2)
        out_mc = jnp.sqrt(peb / p2).astype(jnp.complex64) * ph
        # other channels lock to the leader's phase
        ph_c = out_mc[None] * lockb
        p2_c = jnp.square(jnp.abs(ph_c))
        tiny_c = p2_c <= EPS
        ph_c = jnp.where(tiny_c, pic, ph_c)
        p2_c = jnp.where(tiny_c, jnp.square(jnp.abs(pic)) + EPS, p2_c)
        out_c = jnp.sqrt(pec / p2_c).astype(jnp.complex64) * ph_c
        out_b = jnp.where(jnp.arange(c_n) == mcb, out_mc, out_c)
        ring = jnp.concatenate([ring[1:], ri(out_b)[None]], axis=0)
        return ring, ri(out_b)

    ring0 = jnp.zeros((long_step, c_n, 2), jnp.float32)
    _, outs_ri = jax.lax.scan(body, ring0, xs, unroll=8)
    return cx(outs_ri).T  # [C, B]


def spectral_hop_batched(
    cfg: SpectralConfig,
    state: SpectralState,      # leading [S] axis on every leaf
    spec_in: jnp.ndarray,      # [S, C, bands]
    spec_prev: jnp.ndarray,    # [S, C, bands]
    time_factor, mult, limit,  # [S]
    formant_factor=None, formant_compensation=None, formant_base=None,
):
    """One hop for a whole pool: steps 3-6 vmapped, the sequential band
    chain through :func:`band_chain_batched` (the Triton kernel on the
    GPU, where a vmapped lax.scan costs at least one launch per band)."""
    c_n, b_n = cfg.channels, cfg.bands
    if formant_factor is None:
        gather = jax.vmap(
            lambda st, si, sp, t, m, l: _chain_inputs(cfg, st, si, sp, t, m, l)
        )
        chain, carried = gather(state, spec_in, spec_prev, time_factor, mult, limit)
    else:
        gather = jax.vmap(
            lambda st, si, sp, t, m, l, a, b, c: _chain_inputs(
                cfg, st, si, sp, t, m, l, a, b, c
            )
        )
        chain, carried = gather(
            state, spec_in, spec_prev, time_factor, mult, limit,
            formant_factor, formant_compensation, formant_base,
        )
    out = band_chain_batched(cfg, chain)
    new_rng, new_fv, new_fw, pred_energy = carried
    return SpectralState(
        prev_output=out, prev_pred_energy=pred_energy, rng=new_rng,
        f_value_ema=new_fv, f_weighted_ema=new_fw,
    ), out


#: band-chain implementation per platform: the Triton kernel on CUDA GPUs,
#: the lax.scan on the CPU (the test platform).  The one backend-dependent
#: choice in the program; no other platform has a band chain.
_CHAIN_IMPL = {"cpu": "scan", "cuda": "kernel", "gpu": "kernel"}


def band_chain_impl(platform: str) -> str:
    """``"kernel"`` or ``"scan"`` for a JAX platform name (``"cpu"``,
    ``"gpu"``/``"cuda"``); raises ``ValueError`` for any other platform."""
    try:
        return _CHAIN_IMPL[platform]
    except KeyError:
        raise ValueError(
            f"no band-chain implementation for platform {platform!r}"
        ) from None


def band_chain_batched(cfg: SpectralConfig, chain) -> jnp.ndarray:
    """The band chain of a whole pool ([S]-batched ``chain`` tuple ->
    [S, C, B] complex64), resolved per platform when the step is lowered
    (``lax.platform_dependent``: an exported CUDA graph holds the kernel
    even when traced on the CPU; lowering for any platform not in
    ``_CHAIN_IMPL`` fails)."""
    impls = {
        "scan": jax.vmap(functools.partial(_band_chain_scan, cfg)),
        "kernel": functools.partial(_band_chain_kernel, cfg),
    }
    return jax.lax.platform_dependent(chain, **{
        p: impls[band_chain_impl(p)] for p in ("cpu", "cuda")
    })


def _band_chain_kernel(cfg: SpectralConfig, chain,
                       interpret: bool = False) -> jnp.ndarray:
    """Pack batched chain inputs into the bandchain kernel layout
    ([planes, B, S_padded], streams minor) and unpack [S, C, B]."""
    from bauklank.ops.pallas.bandchain import TILE, band_chain

    d1, d2, u12, pe_mc, pi_mc, mc, lock, pred_energy, pred_input = chain
    s_n = pe_mc.shape[0]
    c_n = cfg.channels
    pad = (-s_n) % TILE

    def bt(x):  # [S, B] -> [B, S_padded] f32
        x = x.astype(jnp.float32).T
        return jnp.pad(x, ((0, 0), (0, pad)))

    def bt2(z):  # complex [S, B] -> (re, im) [B, S_padded]
        return bt(jnp.real(z)), bt(jnp.imag(z))

    lead = jnp.stack([*bt2(d1), *bt2(d2), *bt2(u12), *bt2(pi_mc), bt(pe_mc),
                      bt(mc)])                        # [10, B, S_padded]
    chan = jnp.stack([
        jnp.stack([*bt2(lock[:, c]), bt(pred_energy[:, c]),
                   *bt2(pred_input[:, c])])
        for c in range(c_n)
    ])                                                # [C, 5, B, S_padded]
    out = band_chain(lead, chan, long_step=cfg.long_step,
                     interpret=interpret)             # [C, 2, B, S_padded]
    out_c = jax.lax.complex(out[:, 0], out[:, 1])[..., :s_n]  # [C, B, S]
    return out_c.transpose(2, 0, 1)  # [S, C, B]
