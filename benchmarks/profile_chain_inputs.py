"""Stage decomposition of the fidelity chain-inputs cost (round 3).

This script times each constituent stage of chain_inputs_hops at the serving shape to find where it goes:
smoothers, peak map (scatter-adds), the five-family row gathers, the
energy/prev gathers, MINSTD draws, and the elementwise tail.

Usage: PYTHONPATH=. python benchmarks/profile_chain_inputs.py [S] [H]
"""

from __future__ import annotations

import sys
import time

import numpy as np

SR = 44100.0


def main():
    import jax
    import jax.numpy as jnp

    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bauklank.engine.spectral import (
        SpectralConfig,
        _find_peaks_map,
        _get_fractional,
        _get_fractional_multi,
        _minstd_steps,
        _smooth_bidirectional,
    )

    s = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    block = round(0.12 * SR)
    interval = round(0.03 * SR)
    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    b_n, fft, c_n, L = cfg.bands, cfg.fft, cfg.channels, cfg.long_step
    print(f"device={jax.devices()[0]} S={s} H={h} B={b_n}", file=sys.stderr)
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))
    reps = 10

    def timeit(name, fn, *args):
        out = fn(*args)
        float(fence(jax.tree.leaves(out)[0].real))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        float(fence(jax.tree.leaves(out)[0].real))
        dt = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:40s} {dt:9.2f} ms   ({dt/h:6.2f} /hop)")
        return out

    rng = np.random.default_rng(0)
    hs = h * s
    spec = jnp.asarray(
        (rng.standard_normal((hs, c_n, b_n, 2)) * 0.3).astype(np.float32)
    )
    spec_c = jax.jit(lambda x: jax.lax.complex(x[..., 0], x[..., 1]))(spec)
    energy = jnp.asarray(
        np.abs(rng.standard_normal((hs, b_n))).astype(np.float32)
    )
    mult = jnp.asarray(
        np.exp2(rng.uniform(-1, 1, hs)).astype(np.float32)
    )
    limit = jnp.full((hs,), 8000.0 / SR, jnp.float32)
    seeds = jnp.asarray(rng.integers(1, 2**31 - 1, hs).astype(np.uint32))
    tfs = jnp.asarray(np.full(hs, 1000.0, np.float32))  # kiosk regime
    pos = jnp.asarray(
        np.clip(
            np.arange(b_n)[None] + rng.standard_normal((hs, b_n)) * 40,
            0, b_n - 1,
        ).astype(np.float32)
    )

    coef = 1.0 / (0.5 * (fft / interval) + 1.0)

    @jax.jit
    def smoothers(e):
        sm, carry = _smooth_bidirectional(e, coef, jnp.zeros((hs,)))
        sm, _ = _smooth_bidirectional(sm, coef, carry)
        return sm

    sm = timeit("double bidirectional smoother", smoothers, energy)

    @jax.jit
    def peaks(e, smv, m, l):
        return jax.vmap(
            lambda ee, ss, mm, ll: _find_peaks_map(ee, ss, mm, ll, b_n, fft)
        )(e, smv, m, l)

    timeit("find_peaks_map (scatters)", peaks, energy, sm, mult, limit)

    from bauklank.engine.spectral import (
        _find_peaks_map_batched,
        _peaks_block_t,
    )

    # production granularity (t=8 wins decisively; see _peaks_block_t) —
    # this rig used to hardcode t=64 and overstated the peaks cost 2.4x
    t_blk = _peaks_block_t(b_n) or 64

    @jax.jit
    def peaks_batched(e, smv, m, l):
        return _find_peaks_map_batched(e, smv, m, l, b_n, fft, t_blk)

    timeit("find_peaks_map_batched (blockgather)", peaks_batched,
           energy, sm, mult, limit)

    @jax.jit
    def minstd(sd, tf):
        return jax.vmap(lambda a, b: _minstd_steps(a, b, b_n))(sd, tf)

    timeit("minstd draws", minstd, seeds, tfs)

    @jax.jit
    def gather5(spc, p):
        def one(sp, pp):
            return _get_fractional_multi(
                sp, [pp, pp - 1.0, pp - 5.0, pp + 1.0, pp + 5.0]
            )
        return jax.vmap(one)(spc, p)

    timeit("five-family complex gather", gather5, spec_c, pos)

    @jax.jit
    def gather1(spc, p):
        return jax.vmap(_get_fractional)(spc, p)

    timeit("single complex gather (1 family)", gather1, spec_c, pos)

    @jax.jit
    def gather_real(e, p):
        return jax.vmap(_get_fractional)(e[:, None, :].repeat(c_n, 1), p)

    timeit("energy gather (real)", gather_real, energy, pos)

    @jax.jit
    def tail(spc):
        pe = jnp.square(jnp.abs(spc))
        mc = jnp.argmax(pe, axis=1)
        onehot = (
            jnp.arange(c_n)[None, :, None] == mc[:, None, :]
        ).astype(jnp.float32)
        d1 = jnp.sum(spc * jnp.conj(spc) * onehot, axis=1)
        lock = jnp.conj(jnp.sum(spc * onehot, axis=1)[:, None] * jnp.conj(spc))
        return d1, lock

    timeit("elementwise tail (argmax/sel/lock)", tail, spec_c)


if __name__ == "__main__":
    main()
