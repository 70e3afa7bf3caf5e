"""ops.windowgather: the XLA shared-window six-family gather must be
BIT-IDENTICAL (after the top-level weighted combine) to the generic
`ops.blockgather.block_gather` path it replaces in the deterministic
time-step regime — over adversarial positions: negative (down_l below
band 0), >= B (upper taps past the grid), exact integers (frac == 0),
block boundaries, anchor-clip cases, and the us/ul shifted tail lanes
(pos = -c / -L*c, where only an upper tap at band 0 can be valid)."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from bauklank.ops.blockgather import block_gather
from bauklank.ops.windowgather import window_gather_taps, window_t1

B = 192          # smallest grid window_t1 accepts at t1=16 (192/16 = 12)
L = 5            # cfg.long_step


def _pos5_det(input_bin: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The five-family position table exactly as _hop_pre_gather builds
    it in the deterministic regime (d_down == d_up == the scalar c):
    engine/spectral.py:916-927."""
    n, b = input_bin.shape
    cc = c[:, None]
    us = np.concatenate([input_bin[:, 1:], np.zeros((n, 1), np.float32)], 1) - cc
    ul = (
        np.concatenate([input_bin[:, L:], np.zeros((n, L), np.float32)], 1)
        - cc * L
    )
    return np.concatenate(
        [input_bin, input_bin - cc, input_bin - cc * L, us, ul], axis=1
    ).astype(np.float32)


def _weights(pos: jnp.ndarray, b: int):
    """block_gather's weight formula (ops/blockgather.py:80-87)."""
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - i0).astype(jnp.float32)
    ok0 = ((i0 >= 0) & (i0 < b)).astype(jnp.float32)
    ok1 = ((i0 + 1 >= 0) & (i0 + 1 < b)).astype(jnp.float32)
    return ok0 * (1.0 - frac), ok1 * frac


@pytest.mark.parametrize(
    "fetch,geom",
    [("einsum", None), ("gather", None), ("einsum", (8, 20)),
     ("einsum", (8, 32)), ("einsum", (16, 32)), ("einsum_bm", None),
     ("einsum_bm", (8, 20)), ("einsum_bm", (16, 32)),
     ("einsum_bm", (32, 44)), ("einsum_bm", (64, 76)),
     ("einsum_m1", None), ("einsum_m1", (8, 20)), ("einsum_m1", (16, 32)),
     ("einsum2", None)],
)
@pytest.mark.parametrize("n", [3, 12])  # below and above the chunk size
def test_window_gather_bit_identical_vs_block_gather(n, fetch, geom):
    rng = np.random.default_rng(7)
    c_n = 2
    t1 = window_t1(B, L)
    assert t1 == 16

    spec = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    prev = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    en = np.abs(rng.standard_normal((n, B, c_n))).astype(np.float32)

    # adversarial input_bin rows: identity, random in-range fractional,
    # block boundaries / exact ints, near-0 (anchor clip), near/past B
    ib = np.empty((n, B), np.float32)
    for i in range(n):
        kind = i % 5
        if kind == 0:
            ib[i] = np.arange(B)
        elif kind == 1:
            ib[i] = np.sort(rng.uniform(0, B - 1, B)).astype(np.float32)
        elif kind == 2:
            ib[i] = np.clip(np.arange(B) // 16 * 16.0, 0, B - 1)  # exact ints
        elif kind == 3:
            ib[i] = np.clip(np.arange(B) * 0.11, 0, 10.9)  # anchor clip at 0
        else:
            ib[i] = np.clip(np.arange(B) * 1.07 + 0.37, 0, B + 4.5)  # past B
    c = np.asarray([0.5, 1.0, 1.37, 2.0] * ((n + 3) // 4))[:n].astype(np.float32)
    pos5 = _pos5_det(ib, c)

    spec_j = jnp.asarray(spec)
    prev_j = jnp.asarray(prev)
    en_j = jnp.asarray(en)
    ib_j = jnp.asarray(ib)
    pos5_j = jnp.asarray(pos5)

    ga5, gb5, gac, gbc = window_gather_taps(
        spec_j, prev_j, en_j, ib_j, pos5_j, jnp.asarray(c),
        long_step=L, t1=t1, chunk=8, fetch=fetch, geom=geom)
    w05, w15 = _weights(pos5_j, B)
    w0c, w1c = _weights(ib_j, B)
    five_w = np.asarray(ga5 * w05[..., None] + gb5 * w15[..., None])
    comb_w = np.asarray(gac * w0c[..., None] + gbc * w1c[..., None])

    five_ref = np.asarray(block_gather(spec_j, pos5_j, t=8, chunk=8))
    comb = jnp.concatenate([prev_j, en_j], axis=-1)
    comb_ref = np.asarray(block_gather(comb, ib_j, t=8, chunk=8))

    np.testing.assert_array_equal(five_w, five_ref)
    np.testing.assert_array_equal(comb_w, comb_ref)

    # plane-major epilogue (out_layout="pm"): the [N, P, K] taps combined
    # plane-major must equal the band-major result exactly — the serving
    # path consumes this layout (engine/spectral plane-major epilogue)
    pa5, pb5, pac, pbc = window_gather_taps(
        spec_j, prev_j, en_j, ib_j, pos5_j, jnp.asarray(c),
        long_step=L, t1=t1, chunk=8, fetch=fetch, geom=geom,
        out_layout="pm")
    five_pm = np.asarray(pa5 * w05[:, None, :] + pb5 * w15[:, None, :])
    comb_pm = np.asarray(pac * w0c[:, None, :] + pbc * w1c[:, None, :])
    np.testing.assert_array_equal(five_pm.transpose(0, 2, 1), five_ref)
    np.testing.assert_array_equal(comb_pm.transpose(0, 2, 1), comb_ref)


@pytest.mark.parametrize("branch,geom2", [
    ("two_level", (32, 16)), ("two_level", (16, 16)),
    ("fallback", (32, 16)), ("fallback", (32, 8)),
])
def test_window_gather_einsum2_both_guard_branches(branch, geom2):
    """einsum2 must be bit-identical to block_gather on BOTH sides of
    its spread guard: benign maps (slope <= 2.5, the peaks-map bound)
    take the two-level branch; a map with a giant intra-block anchor
    jump must trip the exact integer guard into the single-level
    fallback.  Both asserted against the generic oracle."""
    rng = np.random.default_rng(3)
    n, c_n = 12, 2
    spec = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    prev = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    en = np.abs(rng.standard_normal((n, B, c_n))).astype(np.float32)

    ib = np.empty((n, B), np.float32)
    for i in range(n):
        if branch == "two_level":
            # slopes spanning the provable [0.25, 2.5] hull + jitter
            slope = 0.25 + 2.25 * (i / max(n - 1, 1))
            ib[i] = np.clip(
                np.arange(B) * slope + rng.uniform(-0.4, 0.4, B), 0, B - 1)
        else:
            # one pathological row trips the GLOBAL guard for the batch
            ib[i] = np.arange(B, dtype=np.float32)
    if branch == "fallback":
        ib[0] = np.where(np.arange(B) % 32 < 16, 0.0, B - 1.0)  # giant jumps
    c = np.asarray([0.5, 1.0, 1.37, 2.0] * 3)[:n].astype(np.float32)
    pos5 = _pos5_det(ib, c)

    spec_j, prev_j, en_j = map(jnp.asarray, (spec, prev, en))
    ib_j, pos5_j = jnp.asarray(ib), jnp.asarray(pos5)

    # check the guard lands on the intended branch (mirrors the op's law)
    anchor = np.clip(np.floor(ib - 5.0 * c[:, None]).astype(np.int64), 0, B - 1)
    g2, nstrip = geom2
    anc_b = anchor.reshape(n, B // g2, g2)
    fbrel = anc_b // 8 - (anc_b.min(2, keepdims=True) // 8)
    took_two = fbrel.max() <= nstrip - (20 + 7) // 8
    assert took_two == (branch == "two_level"), (fbrel.max(), geom2)

    ga5, gb5, gac, gbc = window_gather_taps(
        spec_j, prev_j, en_j, ib_j, pos5_j, jnp.asarray(c),
        long_step=L, t1=16, chunk=8, fetch="einsum2", geom2=geom2)
    w05, w15 = _weights(pos5_j, B)
    w0c, w1c = _weights(ib_j, B)
    five_w = np.asarray(ga5 * w05[..., None] + gb5 * w15[..., None])
    comb_w = np.asarray(gac * w0c[..., None] + gbc * w1c[..., None])

    five_ref = np.asarray(block_gather(spec_j, pos5_j, t=8, chunk=8))
    comb = jnp.concatenate([prev_j, en_j], axis=-1)
    comb_ref = np.asarray(block_gather(comb, ib_j, t=8, chunk=8))
    np.testing.assert_array_equal(five_w, five_ref)
    np.testing.assert_array_equal(comb_w, comb_ref)

    # pm layout through the SAME guard branch (the serving path's layout;
    # ADVICE r4: the pm identity check previously only ever saw the
    # two-level branch via the generic first test)
    pa5, pb5, pac, pbc = window_gather_taps(
        spec_j, prev_j, en_j, ib_j, pos5_j, jnp.asarray(c),
        long_step=L, t1=16, chunk=8, fetch="einsum2", geom2=geom2,
        out_layout="pm")
    five_pm = np.asarray(pa5 * w05[:, None, :] + pb5 * w15[:, None, :])
    comb_pm = np.asarray(pac * w0c[:, None, :] + pbc * w1c[:, None, :])
    np.testing.assert_array_equal(five_pm.transpose(0, 2, 1), five_ref)
    np.testing.assert_array_equal(comb_pm.transpose(0, 2, 1), comb_ref)


def test_window_gather_tail_lanes_only_upper_tap():
    """The last shift lanes of us/ul (positions -c, -L*c): c < 1 leaves a
    valid upper tap at band 0; c >= 1 leaves nothing."""
    rng = np.random.default_rng(1)
    n, c_n = 2, 1
    spec = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    prev = rng.standard_normal((n, B, 2 * c_n)).astype(np.float32)
    en = np.abs(rng.standard_normal((n, B, c_n))).astype(np.float32)
    ib = np.tile(np.arange(B, dtype=np.float32), (n, 1))
    c = np.asarray([0.75, 1.5], np.float32)   # one each side of 1
    pos5 = _pos5_det(ib, c)

    ga5, gb5, gac, gbc = window_gather_taps(
        jnp.asarray(spec), jnp.asarray(prev), jnp.asarray(en),
        jnp.asarray(ib), jnp.asarray(pos5), jnp.asarray(c),
        long_step=L, t1=16, chunk=8)
    w05, w15 = _weights(jnp.asarray(pos5), B)
    five_w = np.asarray(ga5 * w05[..., None] + gb5 * w15[..., None])
    five_ref = np.asarray(
        block_gather(jnp.asarray(spec), jnp.asarray(pos5), t=8, chunk=8))
    np.testing.assert_array_equal(five_w, five_ref)
    # us tail lane (family 3, band B-1): pos = -c
    us_tail = five_w[:, 4 * B - 1]
    assert np.array_equal(us_tail[0], spec[0, 0] * 0.25)  # upper tap, frac .25
    assert np.all(us_tail[1] == 0.0)                      # c=1.5: no tap
