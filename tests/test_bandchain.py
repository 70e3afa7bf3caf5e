"""The Triton band-chain kernel (interpret mode) against a straight-numpy
restatement of the chain and against the engine's ``lax.scan`` form."""

import functools

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from bauklank.engine.spectral import (  # noqa: E402
    SpectralConfig,
    _band_chain_kernel,
    _band_chain_scan,
    band_chain_batched,
    band_chain_impl,
)
from bauklank.ops.pallas.bandchain import TILE, UNROLL, band_chain  # noqa: E402

EPS = 1e-15


def _chain_numpy(d1, d2, u, pe, pi, mc, lock, pec, pic, long_step):
    """[S] streams x [B] bands x [C] channels reference chain (float64)."""
    s_n, b_n = pe.shape
    c_n = lock.shape[0]
    out = np.zeros((c_n, s_n, b_n), complex)
    for s in range(s_n):
        for b in range(b_n):
            m = mc[s, b]
            ph = u[s, b]
            if b >= 1:
                ph += out[m, s, b - 1] * d1[s, b]
            if b >= long_step:
                ph += out[m, s, b - long_step] * d2[s, b]
            p2 = abs(ph) ** 2
            if p2 <= EPS:
                ph = pi[s, b]
                p2 = abs(ph) ** 2 + EPS
            om = np.sqrt(pe[s, b] / p2) * ph
            for c in range(c_n):
                if c == m:
                    out[c, s, b] = om
                    continue
                phc = om * lock[c, s, b]
                p2c = abs(phc) ** 2
                if p2c <= EPS:
                    phc = pic[c, s, b]
                    p2c = abs(phc) ** 2 + EPS
                out[c, s, b] = np.sqrt(pec[c, s, b] / p2c) * phc
    return out


def _random_chain(s_n, b_n, c_n, seed=3):
    """Chain operands in the engine's [S, ...] layout, with exact zeros at
    band 5 to exercise the EPS fallbacks."""
    rng = np.random.default_rng(seed)

    def cplx(shape):
        return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                * 0.5).astype(np.complex64)

    d1, d2, u, pi = (cplx((s_n, b_n)) for _ in range(4))
    pe = np.abs(rng.standard_normal((s_n, b_n))).astype(np.float32) + 0.01
    mc = rng.integers(0, c_n, (s_n, b_n)).astype(np.int32)
    lock = cplx((s_n, c_n, b_n)) * 2
    pec = np.abs(rng.standard_normal((s_n, c_n, b_n))).astype(np.float32) + 0.01
    pic = cplx((s_n, c_n, b_n)) * 2
    if b_n > 5:
        u[:, 5] = 0.0
        d1[:, 5] = 0.0
        d2[:, 5] = 0.0
    return d1, d2, u, pe, pi, mc, lock, pec, pic


# (channels, long_step, bands, streams): channels 1/2; long_step 1 (kiosk,
# single-row ring), 4, 5 (preset); band counts off the unroll (tail loop)
# and below one unroll; stream counts off the tile (padding) and over it
CASES = [
    (1, 4, 64, TILE),
    (2, 5, 100, 5),
    (2, 1, 37, 33),
    (1, 1, UNROLL - 3, 1),
    (2, 4, 3 * UNROLL, 2 * TILE),
    (1, 5, 71, 7),
]


@pytest.mark.parametrize("c_n,long_step,b_n,s_n", CASES)
def test_band_chain_matches_numpy(c_n, long_step, b_n, s_n):
    d1, d2, u, pe, pi, mc, lock, pec, pic = _random_chain(s_n, b_n, c_n)
    want = _chain_numpy(d1, d2, u, pe, pi, mc,
                        lock.transpose(1, 0, 2), pec.transpose(1, 0, 2),
                        pic.transpose(1, 0, 2), long_step)     # [C, S, B]
    cfg_like = type("Cfg", (), {"channels": c_n, "long_step": long_step})
    got = _band_chain_kernel(
        cfg_like, tuple(map(jnp.asarray, (d1, d2, u, pe, pi, mc, lock, pec,
                                          pic))),
        interpret=True)                                        # [S, C, B]
    # float64 oracle vs the f32 kernel: a few elements near normalization
    # boundaries differ at ~1e-4 (f32 rounding through the chain)
    np.testing.assert_allclose(np.asarray(got).transpose(1, 0, 2), want,
                               rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("c_n,long_step,b_n,s_n", CASES)
def test_band_chain_matches_scan(c_n, long_step, b_n, s_n):
    """Kernel (interpret mode) vs the vmapped lax.scan on identical f32
    inputs.  Tolerance: the kernel forms |z|^2 as re*re + im*im (the
    blob's std::norm) while the scan squares XLA's complex abs, so single
    bands differ in the last bits and the chain carries that forward."""
    chain = tuple(map(jnp.asarray, _random_chain(s_n, b_n, c_n, seed=11)))
    cfg_like = type("Cfg", (), {"channels": c_n, "long_step": long_step,
                                "bands": b_n})
    got = _band_chain_kernel(cfg_like, chain, interpret=True)
    want = jax.vmap(functools.partial(_band_chain_scan, cfg_like))(chain)
    assert got.shape == want.shape == (s_n, c_n, b_n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_band_chain_rejects_untiled_streams():
    """The raw kernel takes only tile-multiple stream counts; the engine
    wrapper pads."""
    lead = jnp.zeros((10, 16, TILE + 1), jnp.float32)
    chan = jnp.zeros((1, 5, 16, TILE + 1), jnp.float32)
    with pytest.raises(ValueError, match="multiple"):
        band_chain(lead, chan, long_step=1, interpret=True)


def test_kernel_matches_scan_on_engine_inputs():
    """On chain inputs the engine builds (spectral_hop_batched's gather
    stage, deterministic and MINSTD streams), the kernel matches the
    scan, and ``band_chain_batched`` on the CPU is the scan exactly."""
    from bauklank.engine.spectral import _chain_inputs, init_spectral_state

    cfg = SpectralConfig(2, 256, 64)
    s_n = 4
    rng = np.random.default_rng(9)

    def spectra(shape):
        re = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        return jax.jit(jax.lax.complex)(re, im)

    si = spectra((s_n, cfg.channels, cfg.bands))
    sp = spectra((s_n, cfg.channels, cfg.bands))
    states = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (s_n,) + x.shape).copy(),
        init_spectral_state(cfg),
    )
    tf = jnp.asarray(np.linspace(0.8, 4.0, s_n), jnp.float32)  # incl. MINSTD
    mult = jnp.asarray(np.linspace(0.7, 1.6, s_n), jnp.float32)
    lim = jnp.full((s_n,), 0.18, jnp.float32)
    chain, _ = jax.vmap(
        lambda st, a, b, t, m, l: _chain_inputs(cfg, st, a, b, t, m, l)
    )(states, si, sp, tf, mult, lim)

    k = _band_chain_kernel(cfg, chain, interpret=True)
    s = jax.vmap(functools.partial(_band_chain_scan, cfg))(chain)
    np.testing.assert_allclose(np.asarray(k), np.asarray(s),
                               rtol=1e-5, atol=1e-6)
    dispatched = jax.jit(functools.partial(band_chain_batched, cfg))(chain)
    np.testing.assert_array_equal(np.asarray(dispatched), np.asarray(s))


@pytest.mark.parametrize(
    "platform,impl",
    [("cpu", "scan"), ("gpu", "kernel"), ("cuda", "kernel")],
)
def test_band_chain_impl_per_platform(platform, impl):
    assert band_chain_impl(platform) == impl


@pytest.mark.parametrize("platform", ["rocm", "metal", "", "gpu0"])
def test_band_chain_impl_rejects_other_platforms(platform):
    with pytest.raises(ValueError, match="no band-chain implementation"):
        band_chain_impl(platform)
