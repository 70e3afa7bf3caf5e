"""ops.blockgather vs engine.spectral._get_fractional: bit-exactness.

VERDICT r3 item 2b: the module's "bit-exact vs `_get_fractional`" claim
had no direct unit test.  These tests pin `block_gather` to the gather
oracle with `assert_array_equal` (no tolerance) over adversarial
positions: negative, >= B, block-boundary, exact-integer, and
non-monotone random — the MINSTD vertical-step regime that motivated the
module (reference hot loop app/SignalsmithStretch.mjs:826-954 reads
spectra at fractional bands via getFractional, :265).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from bauklank.engine.spectral import _get_fractional
from bauklank.ops.blockgather import block_gather, block_gather_complex

B = 96   # band count (divides by t=32 -> 3 blocks)
T = 32


def _oracle(arrs: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Per-example `_get_fractional` (the engine's gather path) -> [N, K, P]."""
    out = []
    for n in range(arrs.shape[0]):
        # _get_fractional takes arr [..., B], pos [K] -> [..., K]
        got = _get_fractional(jnp.asarray(arrs[n].T), jnp.asarray(pos[n]))
        out.append(np.asarray(got).T)  # [P, K] -> [K, P]
    return np.stack(out)


def _adversarial_positions(rng, n, k):
    """Mix of every edge class, non-monotone."""
    cases = np.concatenate([
        rng.uniform(-5.0, B + 5.0, size=(n, k - 12)),    # wide random
        np.tile([-1.0, -0.5, -1e-3, 0.0, float(B) - 1.0,  # edges
                 float(B) - 0.5, float(B), float(B) + 2.0,
                 float(T) - 1e-3, float(T), 2.0 * T - 0.25, 17.0],
                (n, 1)),
    ], axis=1).astype(np.float32)
    # shuffle per-row so positions are non-monotone
    for row in cases:
        rng.shuffle(row)
    return cases


@pytest.mark.parametrize("layout", ["kmaj", "kmin"])
@pytest.mark.parametrize("n,k,p,chunk", [
    (4, 24, 2, 16),    # unchunked (n <= chunk)
    (36, 24, 2, 16),   # chunked with remainder (36 % 16 != 0 — ADVICE r3 pad path)
    (32, 24, 1, 16),   # chunked exact multiple
])
def test_block_gather_bit_exact_vs_get_fractional(n, k, p, chunk, layout):
    rng = np.random.default_rng(7)
    arrs = rng.standard_normal((n, B, p)).astype(np.float32)
    pos = _adversarial_positions(rng, n, k)
    got = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos),
                                  t=T, chunk=chunk, layout=layout))
    np.testing.assert_array_equal(got, _oracle(arrs, pos))


def test_block_gather_integer_positions_copy_rows_exactly():
    """frac == 0: the output must be the raw row (0/1 one-hot copies f32)."""
    rng = np.random.default_rng(11)
    n, k, p = 3, B, 2
    arrs = rng.standard_normal((n, B, p)).astype(np.float32)
    pos = np.tile(np.arange(B, dtype=np.float32), (n, 1))
    got = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos), t=T))
    np.testing.assert_array_equal(got, arrs)


@pytest.mark.parametrize("layout", ["kmaj", "kmin"])
@pytest.mark.parametrize("n", [3, 40])  # below and above the chunk size
def test_block_gather_int_pos_mode_matches_general(n, layout):
    """int_pos=True (peaks-map boundary/rank lookups): bit-identical to
    the general path over integer positions incl. negative, == B, and
    past-B sentinels (all of which must come back exactly zero)."""
    rng = np.random.default_rng(23)
    arrs = rng.standard_normal((n, B, 3)).astype(np.float32)
    pos = rng.integers(-2, B + 2, (n, B)).astype(np.float32)
    a, pj = jnp.asarray(arrs), jnp.asarray(pos)
    got = np.asarray(block_gather(a, pj, t=T, chunk=16, int_pos=True,
                                  layout=layout))
    ref = np.asarray(block_gather(a, pj, t=T, chunk=16))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(arrs, pos))


def test_block_gather_out_of_range_is_zero():
    rng = np.random.default_rng(13)
    arrs = rng.standard_normal((2, B, 1)).astype(np.float32) + 5.0
    pos = np.array([[-2.0, -1.5, float(B), float(B) + 0.5],
                    [-100.0, float(2 * B), -1.0 - 1e-6, float(B) - 1e-3]],
                   dtype=np.float32)
    got = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos), t=T))
    oracle = _oracle(arrs, pos)
    np.testing.assert_array_equal(got, oracle)
    # fully-outside positions are exactly zero
    assert got[0, 0, 0] == 0.0 and got[1, 0, 0] == 0.0 and got[1, 1, 0] == 0.0


def test_block_gather_complex_matches_planes():
    rng = np.random.default_rng(17)
    n, k = 5, 20
    re = rng.standard_normal((n, B)).astype(np.float32)
    im = rng.standard_normal((n, B)).astype(np.float32)
    arrs = re + 1j * im
    pos = _adversarial_positions(rng, n, k)
    got = np.asarray(block_gather_complex(jnp.asarray(arrs), jnp.asarray(pos), t=T))
    planes = _oracle(np.stack([re, im], axis=-1), pos)
    np.testing.assert_array_equal(np.real(got), planes[..., 0])
    np.testing.assert_array_equal(np.imag(got), planes[..., 1])


@pytest.mark.parametrize("mode", ["bf16x3", "int8x4"])
def test_block_gather_split_modes_bit_exact(mode):
    """The reduced-pass selection modes must equal the HIGHEST f32 form
    bit for bit (selection sums have one nonzero term; the splits
    reconstruct f32 exactly — int8x4 for every bit pattern, bf16x3 down
    to ~2^-100)."""
    rng = np.random.default_rng(23)
    n, k, p = 36, 24, 3
    arrs = (rng.standard_normal((n, B, p)) *
            10.0 ** rng.uniform(-20, 20, (n, B, p))).astype(np.float32)
    pos = _adversarial_positions(rng, n, k)
    ref = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos), t=T))
    got = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos),
                                  t=T, mode=mode))
    np.testing.assert_array_equal(got, ref)


def test_block_gather_int8x4_exact_on_denormals():
    """int8x4 selects the raw bit pattern, so even f32 denormals (where
    bf16x3's third residual underflows) match the HIGHEST mode and the
    gather oracle bit for bit.  (The comparison is against those paths,
    not the raw array: the tap stage shared by ALL modes may flush
    subnormals on some backends — what the mode must not change is the
    output.)"""
    rng = np.random.default_rng(29)
    n, p = 2, 2
    arrs = np.zeros((n, B, p), np.float32)
    arrs[..., 0] = (rng.standard_normal((n, B)) *
                    10.0 ** rng.uniform(-45, 38, (n, B))).astype(np.float32)
    arrs[..., 1] = 1e-40  # subnormal plane
    pos = np.tile(np.arange(B, dtype=np.float32), (n, 1))
    got = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos),
                                  t=T, mode="int8x4"))
    ref = np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos), t=T))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(arrs, pos))


def test_block_gather_chunk_padding_matches_unchunked():
    """The ADVICE-r3 pad path (n % chunk != 0) must equal the one-shot form."""
    rng = np.random.default_rng(19)
    n, k, p = 21, 16, 3
    arrs = rng.standard_normal((n, B, p)).astype(np.float32)
    pos = _adversarial_positions(rng, n, k)
    a, b = (np.asarray(block_gather(jnp.asarray(arrs), jnp.asarray(pos),
                                    t=T, chunk=c)) for c in (8, 64))
    np.testing.assert_array_equal(a, b)
