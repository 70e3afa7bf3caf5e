"""Unit tests for the blob-exact JAX spectral core (engine/spectral.py).

The oracle is tools/golden_wasm/pymodel.py — itself pinned hop-exact
against the live blob (tests/test_pymodel.py) — so these run with no
compiler and no fixtures.  Tolerances reflect float32 vs float64 noise
amplified by the band recurrence (measured ~1e-4 worst case).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, "tools")
from golden_wasm.pymodel import ModelConfig, SpectralModel  # noqa: E402

from bauklank.engine.fidelity import render_fidelity
from bauklank.engine.spectral import (
    SpectralConfig,
    blob_window,
    fft_size_for,
    init_spectral_state,
    spectral_hop,
)

import jax.numpy as jnp


def _colored_spectra(rng, c, bands, fft, interval, rot_frac=0.7):
    env = (
        np.exp(-((np.arange(bands) - bands / 5) ** 2) / (2 * (bands / 20) ** 2))
        + 0.3 * np.exp(-((np.arange(bands) - bands / 2.5) ** 2) / (2 * (bands / 30) ** 2))
        + 0.01
    )
    si = ((rng.standard_normal((c, bands)) + 1j * rng.standard_normal((c, bands))) * env).astype(np.complex64)
    ph = np.exp(-1j * 2 * np.pi * (np.arange(bands) + 0.5) * interval / fft * rot_frac)
    sp = (si * ph + 0.01 * (rng.standard_normal((c, bands)) + 1j * rng.standard_normal((c, bands)))).astype(np.complex64)
    return si, sp


@pytest.mark.parametrize(
    "channels,block,interval,semitones",
    [(1, 512, 128, 0.0), (1, 512, 128, 12.0), (2, 512, 128, -7.0), (1, 500, 160, 5.0),
     # overlap = 1 (interval == block): the DEPLOYED kiosk geometry class
     # (blockMs=200/overlap=1.0, app/multi/app.mjs:124-130) — long_step
     # degenerates to 1 and the OLA has no window overlap
     (1, 512, 512, 5.0), (2, 512, 512, 0.0)],
)
def test_hop_matches_pymodel(channels, block, interval, semitones):
    cfg = SpectralConfig(channels, block, interval)
    ref_cfg = ModelConfig(channels, block, interval)
    assert cfg.fft == ref_cfg.fft_size and cfg.bands == ref_cfg.bands
    mult = float(np.exp2(semitones / 12.0))
    limit = (8000.0 / 44100.0) / np.sqrt(mult)
    rng = np.random.default_rng(7)
    pm = SpectralModel(ref_cfg)
    st = init_spectral_state(cfg)
    tf = 1.0 / 0.7
    for _ in range(4):
        si, sp = _colored_spectra(rng, channels, cfg.bands, cfg.fft, interval)
        ref = pm.hop(si.astype(complex), sp.astype(complex), tf,
                     freq_multiplier=mult, freq_tonality_limit=limit)
        st, out = spectral_hop(
            cfg, st, jnp.asarray(si), jnp.asarray(sp),
            jnp.float32(tf), jnp.float32(mult), jnp.float32(limit),
        )
        err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
        assert err < 2e-3, err


def test_fft_size_rule():
    # measured table from the blob (docs/WASM-ALGO.md "Sizes")
    for block, fft in [(1000, 1024), (1025, 1280), (2200, 2560), (3100, 4096),
                       (4097, 5120), (5292, 6144), (6000, 6144), (7000, 8192)]:
        assert fft_size_for(block) == fft, block


def test_blob_window_is_forced_cola():
    for block, interval in [(512, 128), (5292, 1323), (500, 160)]:
        w = blob_window(block, interval)
        s = np.zeros(block)
        for h in range(-block // interval - 2, block // interval + 3):
            idx = np.arange(block) - h * interval
            ok = (idx >= 0) & (idx < block)
            s[ok] += w[idx[ok]] ** 2
        np.testing.assert_allclose(s, 1.0, atol=1e-12)


def test_identity_passthrough():
    """Rate 1 / factor 1 file playback reproduces the input at ZERO lag:
    the worklet drive pre-compensates both latencies in its inputTime math
    (the seek window ends at round(inputTime*sr) + inputLatency with
    outputTime already advanced by outputLatency), so scheduled input time
    t plays at output time t — reference app/SignalsmithStretch.mjs:840,
    891-936.  Measured best-lag is exactly 0."""
    sr = 44100.0
    n = int(1.2 * sr)
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 330 * t) * (1 + 0.2 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)[None]
    n_out = int(1.0 * sr)
    out = render_fidelity(x, sr, n_out, rate=1.0, semitones=0.0)
    skip = round(0.15 * sr) + 128  # ramp-in: block + interval
    a = x[0, skip:n_out]
    b = out[0, skip:n_out]
    snr = 10 * np.log10(np.mean(a**2) / np.mean((a - b) ** 2))
    assert snr > 45.0, snr


def test_node_fidelity_matches_offline():
    """StretchNode(engine='fidelity') streaming == render_fidelity offline
    for a constant-rate schedule (same frame-end drive, same core)."""
    from bauklank.node import StretchNode

    sr = 44100.0
    t = np.arange(int(1.5 * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    rate, semitones = 0.8, 4.0
    node = StretchNode(sample_rate=sr, channels=1, engine="fidelity")
    node.configure(blockMs=512 / 44.1, intervalMs=128 / 44.1)
    assert node.block_samples == 512 and node.interval_samples == 128
    node.add_buffers([x])
    node.start(when=0.0, offset=0.0, rate=rate, semitones=semitones)
    n_out = 128 * 64
    got = node.process_output(n_out)

    ref = render_fidelity(
        x[None], sr, n_out, rate=rate, semitones=semitones,
        block_ms=512 / 44.1, interval_ms=128 / 44.1,
    )
    # drives differ only in inputTime sampling granularity (per hop vs per
    # 128-sample browser quantum); with interval == quantum they coincide
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


def test_pool_fidelity_voice_matches_node():
    """StreamPool(engine='fidelity') per-voice output == the single node."""
    from bauklank.node import StretchNode
    from bauklank.serve.pool import StreamPool
    from bauklank.engine.config import StretchConfig

    sr = 44100.0
    t = np.arange(int(1.0 * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    cfg = StretchConfig(channels=1, block=512, interval=128)
    pool = StreamPool(capacity=2, sample_rate=sr, channels=1, config=cfg,
                      max_track_sec=2.0, engine="fidelity")
    assert pool.scfg.block == 512
    pool.load_track("s00", [x])
    pool.schedule("s00", {"active": True, "input": 0.0, "output": 0.0,
                          "rate": 0.8, "semitones": 4.0})
    chunks = [pool.step()[1][0] for _ in range(16)]
    got = np.concatenate([np.asarray(c) for c in chunks], axis=-1)

    node = StretchNode(sample_rate=sr, channels=1, engine="fidelity")
    node.configure(block=512, interval=128)
    node.add_buffers([x])
    node.schedule({"active": True, "input": 0.0, "output": 0.0,
                   "rate": 0.8, "semitones": 4.0})
    ref = node.process_output(16 * 128)
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


@pytest.mark.parametrize("tf,seed,interval", [
    (4.0, 12345, 128), (1000.0, 777, 128),
    # overlap-1 geometry at the saturated tf (the blob's seek clamps the
    # effective timeFactor at `interval` — tf 512 is the max reachable at
    # interval 512; long_step = 1 here)
    (512.0, 271828183, 512),
])
def test_hop_matches_pymodel_minstd(tf, seed, interval):
    """timeFactor > 2 (rate < 0.5, the kiosk regime): the JAX engine must
    replicate the blob's MINSTD-random vertical steps draw-for-draw (the
    pymodel is itself pinned hop-exact to the live blob at these rates,
    tests/test_pymodel.py)."""
    cfg = SpectralConfig(1, 512, interval)
    ref_cfg = ModelConfig(1, 512, interval)
    mult = float(np.exp2(5.0 / 12.0))
    limit = (8000.0 / 44100.0) / np.sqrt(mult)
    rng = np.random.default_rng(3)
    pm = SpectralModel(ref_cfg)
    pm.rng_state = seed
    st = init_spectral_state(cfg, seed=seed)
    for _ in range(3):
        si, sp = _colored_spectra(rng, 1, cfg.bands, cfg.fft, cfg.interval)
        ref = pm.hop(si.astype(complex), sp.astype(complex), tf,
                     freq_multiplier=mult, freq_tonality_limit=limit)
        st, out = spectral_hop(
            cfg, st, jnp.asarray(si), jnp.asarray(sp),
            jnp.float32(tf), jnp.float32(mult), jnp.float32(limit),
        )
        err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
        assert err < 2e-3, err
    # the carried rng state matches the model's exactly
    assert int(st.rng) == pm.rng_state


@pytest.mark.parametrize(
    "factor_st,comp,base,semitones",
    [(5.0, False, 0.0, 0.0), (-7.0, False, 200.0 / 44100.0, 0.0),
     (0.0, True, 0.0, 12.0), (4.0, True, 150.0 / 44100.0, -7.0)],
)
def test_hop_matches_pymodel_formants(factor_st, comp, base, semitones):
    """Step-5 formant processing (shift / compensation / explicit base)
    must match the pymodel, which is pinned hop-exact to the live blob
    (tests/test_pymodel.py formant cases)."""
    cfg = SpectralConfig(1, 512, 128, formants=True)
    ref_cfg = ModelConfig(1, 512, 128)
    mult = float(np.exp2(semitones / 12.0))
    limit = (8000.0 / 44100.0) / np.sqrt(mult)
    ff = float(np.exp2(factor_st / 12.0))
    rng = np.random.default_rng(11)
    pm = SpectralModel(ref_cfg)
    st = init_spectral_state(cfg)
    tf = 1.0 / 0.8
    for _ in range(4):
        si, sp = _colored_spectra(rng, 1, cfg.bands, cfg.fft, cfg.interval)
        ref = pm.hop(si.astype(complex), sp.astype(complex), tf,
                     freq_multiplier=mult, freq_tonality_limit=limit,
                     formant_factor=ff, formant_compensation=comp,
                     formant_base=base)
        st, out = spectral_hop(
            cfg, st, jnp.asarray(si), jnp.asarray(sp),
            jnp.float32(tf), jnp.float32(mult), jnp.float32(limit),
            formant_factor=jnp.float32(ff),
            formant_compensation=jnp.float32(1.0 if comp else 0.0),
            formant_base=jnp.float32(base),
        )
        err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
        assert err < 2e-3, err
    # EMA trackers stay in sync (auto-f0 cases advance, base cases freeze)
    np.testing.assert_allclose(
        float(st.f_value_ema), float(pm.formant_value_ema), rtol=1e-4)


def test_node_fidelity_formants():
    """Fidelity-mode node applies formant controls (full control surface)."""
    from bauklank.node import StretchNode

    sr = 8000.0
    t = np.arange(int(2 * sr)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.25 * np.sin(2 * np.pi * 440 * t)
         + 0.12 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)

    def render(**controls):
        node = StretchNode(sample_rate=sr, channels=1, engine="fidelity")
        node.configure(blockMs=64, overlap=4)
        node.add_buffers([x])
        node.start(when=0.0, offset=0.0, rate=1.0)
        node.schedule({"output": 0.0, "rate": 1.0, **controls})
        return node.process_output(int(sr))

    neutral = render()
    shifted = render(formantSemitones=7.0)
    comp = render(semitones=12.0, formantCompensation=True)
    for out in (neutral, shifted, comp):
        assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    # formant shift must actually reshape the spectrum
    assert np.abs(shifted - neutral).max() > 1e-3


@pytest.mark.golden
@pytest.mark.parametrize("formants", [False, "auto", "base", "mixed"])
def test_hop_parallel_chunk_matches_scan_form(formants):
    """batched_fidelity_chunk (hop-parallel precompute, the round-3 serving
    path) must equal batched_fidelity_chunk_scan (the original hop-scan
    form, itself pinned hop-exact vs pymodel) across regimes: rates above
    and below 0.5 (deterministic + MINSTD vertical steps), pitch shift,
    and every formant mode (off / auto-f0 / explicit base / mixed).

    Runs in a fresh subprocess: compiling the scan form SIGSEGVs the
    XLA:CPU compiler only late in a long-lived full-suite process (not
    stack depth, not memory — see tests/util.run_test_fn_in_subprocess);
    a fresh process is the condition known to always pass."""
    from tests.util import run_test_fn_in_subprocess

    run_test_fn_in_subprocess(
        "tests.test_spectral", "_hop_parallel_chunk_matches_scan_form",
        formants,
    )


def _hop_parallel_chunk_matches_scan_form(formants):
    import jax
    import jax.numpy as jnp

    from bauklank.engine.fidelity import (
        SpectralConfig,
        batched_fidelity_chunk,
        batched_fidelity_chunk_scan,
        init_batched_fidelity_state,
    )

    sr = 44100.0
    s, h = 3, 6
    cfg = SpectralConfig(channels=2, block=512, interval=128,
                         formants=bool(formants))
    # tonal material, like the golden fixtures: the engine chaotically
    # amplifies in-spectrum noise (docs/WASM-ALGO.md "Sensitivity"), which
    # would amplify graph-reassociation FP noise too
    t = np.arange(4096) / sr
    sig = np.stack([
        np.stack([(0.3 + 0.05 * c) * np.sin(2 * np.pi * (220 + 5 * k) * t)
                  + 0.2 * np.sin(2 * np.pi * (440 + 3 * c) * t)
                  for c in range(2)])
        for k in range(s)
    ]).astype(np.float32)
    audios = jnp.asarray(sig)
    rates = np.array([0.8, 1.5, 0.25], np.float32)  # last engages MINSTD
    semis = np.array([0.0, 4.0, -7.0], np.float32)
    ends0 = 600 + (np.arange(h)[None] * 128 * rates[:, None]).round()
    ends = jnp.asarray(ends0.astype(np.int32))
    tf = jnp.asarray(1.0 / rates)
    mult = jnp.asarray(np.exp2(semis / 12.0).astype(np.float32))
    limit = jnp.asarray((8000.0 / sr) / np.sqrt(np.exp2(semis / 12.0)),
                        jnp.float32)
    active = jnp.ones((s,), jnp.float32)
    kw = {}
    if formants:
        base = {"auto": [0.0, 0.0, 0.0],
                "base": [200.0, 150.0, 300.0],
                "mixed": [0.0, 200.0, 0.0]}[formants]
        kw = dict(
            formant_factor=jnp.asarray(
                np.exp2(np.array([3.0, -5.0, 0.0]) / 12.0), jnp.float32),
            formant_compensation=jnp.asarray([0.0, 1.0, 1.0], jnp.float32),
            formant_base=jnp.asarray(np.array(base) / sr, jnp.float32),
        )
    st = init_batched_fidelity_state(cfg, s)
    # compare chunk-by-chunk FROM THE SAME carried state (the engine
    # chaotically amplifies sub-ULP differences across hops — docs/
    # WASM-ALGO.md "Sensitivity" — so graph-reassociation noise forbids
    # long accumulation); the scan form advances the shared state
    for k in range(3):
        e = ends + 64 * k
        sa, ea = batched_fidelity_chunk(
            cfg, st, audios, e, tf, mult, limit, active, **kw)
        sb, eb = batched_fidelity_chunk_scan(
            cfg, st, audios, e, tf, mult, limit, active, **kw)
        np.testing.assert_allclose(np.asarray(ea), np.asarray(eb),
                                   rtol=0, atol=2e-4)
        assert int(np.abs(np.asarray(sa[0].rng).astype(np.int64)
                          - np.asarray(sb[0].rng).astype(np.int64)).max()) == 0
        for la, lb in zip(jax.tree.leaves(sa), jax.tree.leaves(sb)):
            np.testing.assert_allclose(
                np.asarray(la), np.asarray(lb), rtol=2e-4, atol=2e-4)
        st = sb


@pytest.mark.golden
@pytest.mark.parametrize("formants", [False, True])
@pytest.mark.parametrize("regime", ["mixed", "det"])
def test_hoisted_chain_inputs_bit_exact_vs_hop_local(formants, regime):
    """_hop_inputs_hoisted (blockgather serving form) vs double-vmapped
    _hop_local_inputs (the pinned hop-exact path): maxdiff == 0 on every
    operand.  This is the micro-check the hoisted-path docstrings demand
    after ANY chain-input change (VERDICT r3 weak #4 made it a real test);
    covers deterministic + MINSTD regimes, neutral + active pitch maps,
    and the formant gain path."""
    import jax

    from bauklank.engine.spectral import (
        SpectralConfig,
        _hop_inputs_hoisted,
        _hop_local_inputs,
    )

    cfg = SpectralConfig(channels=2, block=512, interval=128,
                         formants=formants)
    h, s = 4, 3
    b_n, c_n = cfg.bands, cfg.channels
    rng = np.random.default_rng(5)

    def cplx(*shape):
        env = 0.02 + np.exp(
            -((np.arange(b_n) - b_n / 4.0) ** 2) / (2 * (b_n / 16.0) ** 2)
        )
        z = (rng.standard_normal(shape + (b_n,))
             + 1j * rng.standard_normal(shape + (b_n,))) * env
        return jnp.asarray(z.astype(np.complex64))

    cur = cplx(h, s, c_n)
    prev = cplx(h, s, c_n)
    seeds = jnp.asarray(
        rng.integers(1, 2 ** 31 - 1, (h, s)).astype(np.uint32))
    if regime == "mixed":  # one MINSTD stream -> generic blockgather path
        tf = jnp.asarray([0.8, 2.0, 1000.0], jnp.float32)
    else:  # every stream deterministic -> the shared-window fast
        # branch (ops/windowgather)
        from bauklank.ops.windowgather import window_t1
        assert window_t1(cfg.bands, cfg.long_step) is not None, (
            "det regime must exercise the window-gather branch")
        tf = jnp.asarray([0.8, 2.0, 1.0], jnp.float32)
    mult = jnp.asarray([1.0, 1.3, 0.7], jnp.float32)    # first: map gated off
    limit = jnp.asarray([0.18, 0.12, 0.2], jnp.float32)
    fgain = None
    if formants:
        fgain = jnp.asarray(
            np.exp(rng.standard_normal((h, s, b_n)) * 0.1).astype(np.float32))

    hoisted = _hop_inputs_hoisted(cfg, cur, prev, seeds, tf, mult, limit, fgain)

    if fgain is None:
        f = jax.vmap(
            jax.vmap(
                lambda si, sp, sd, t, m, l: _hop_local_inputs(
                    cfg, si, sp, sd, t, m, l)),
            in_axes=(0, 0, 0, None, None, None),
        )
        local = f(cur, prev, seeds, tf, mult, limit)
    else:
        f = jax.vmap(
            jax.vmap(
                lambda si, sp, sd, t, m, l, g: _hop_local_inputs(
                    cfg, si, sp, sd, t, m, l, g)),
            in_axes=(0, 0, 0, None, None, None, 0),
        )
        local = f(cur, prev, seeds, tf, mult, limit, fgain)

    assert set(hoisted) == set(local)
    for key in sorted(hoisted):
        np.testing.assert_array_equal(
            np.asarray(hoisted[key]), np.asarray(local[key]),
            err_msg=f"operand {key} diverged (must be maxdiff==0)")


def test_node_fidelity_splitoff_matches_offline():
    """StretchNode(engine='fidelity', splitComputation=False) streaming ==
    render_fidelity(split_computation=False) offline: the decoded split-off
    drive (zero-headed prev windows, one interval less latency) must flow
    through the chunked serving path identically."""
    from bauklank.node import StretchNode

    sr = 44100.0
    t = np.arange(int(1.5 * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    rate, semitones = 0.8, 4.0
    node = StretchNode(sample_rate=sr, channels=1, engine="fidelity")
    node.configure(blockMs=512 / 44.1, intervalMs=128 / 44.1,
                   splitComputation=False)
    assert node.output_latency == 256  # no +interval with split off
    node.add_buffers([x])
    node.start(when=0.0, offset=0.0, rate=rate, semitones=semitones)
    n_out = 128 * 48
    got = node.process_output(n_out)

    ref = render_fidelity(
        x[None], sr, n_out, rate=rate, semitones=semitones,
        block_ms=512 / 44.1, interval_ms=128 / 44.1,
        split_computation=False,
    )
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


@pytest.mark.parametrize("n", [8, 18, 32])  # direct, padded-chunk, exact-chunk
def test_count_leq_blocked_matches_searchsorted(n):
    """The 0/1 matmul count (peaks-map searchsorted + sort-free boundary
    compaction) must equal numpy's searchsorted-right for every batch
    residue — including N not a multiple of the chunk, where the inputs
    pad up instead of silently materializing full-batch masks."""
    from bauklank.engine.spectral import _count_leq_blocked

    rng = np.random.default_rng(31)
    out_len, t, src = 192, 16, 301
    u = rng.integers(0, out_len + 1, (n, src)).astype(np.int32)
    got = np.asarray(_count_leq_blocked(jnp.asarray(u), out_len, t, chunk=16))
    grid = np.arange(out_len)
    want = np.stack([
        np.searchsorted(np.sort(row), grid, side="right") for row in u
    ])
    np.testing.assert_array_equal(got, want)
