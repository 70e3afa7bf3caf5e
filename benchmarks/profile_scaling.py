"""Stage decomposition across the batch-scaling shapes (VERDICT r4 weak #4).

Times the hop-parallel serving step's three stages SEPARATELY at
S in {64, 128, 256} x H=8 and S=128 x H=16 so super-linear growth can be
attributed to a stage instead of "plateau":

    analyses          — frames fetch + MDFT FFTs
    chain_inputs_hops — hop-local precompute (peaks map, window gathers)
    chain+synthesis   — whole step minus the above two (sequential scan
                        with the band-chain kernel, synthesis OLA, ring)

Usage: PYTHONPATH=. python benchmarks/profile_scaling.py [reps]
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np

SR = 44100.0


def main():
    import jax
    import jax.numpy as jnp

    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bauklank.engine.fidelity import (
        SpectralConfig,
        analyse_frames,
        batched_fidelity_chunk,
        init_batched_fidelity_state,
    )
    from bauklank.engine.spectral import chain_inputs_hops

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    block = round(0.12 * SR)
    interval = round(0.03 * SR)
    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    print(f"device={jax.devices()[0]}", file=sys.stderr)
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))

    def timeit(fn, *args):
        out = fn(*args)
        float(fence(jax.tree.leaves(out)[0].real))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        float(fence(jax.tree.leaves(out)[0].real))
        return out, (time.perf_counter() - t0) / reps * 1e3

    rng = np.random.default_rng(0)
    rows = []
    for s, h in ((64, 8), (128, 8), (256, 8), (128, 16)):
        audios = jnp.asarray(
            (rng.standard_normal((s, 2, int(6 * SR))) * 0.2).astype(np.float32))
        rates = np.linspace(0.5, 2.0, s).astype(np.float32)
        ends = jnp.asarray(
            600 + block
            + (np.arange(h)[None] * interval * rates[:, None]).round().astype(
                np.int32))
        tf = jnp.asarray(1.0 / rates)
        mult = jnp.asarray(
            np.exp2(np.linspace(-12, 12, s) / 12).astype(np.float32))
        limit = jnp.asarray((8000.0 / SR) / np.sqrt(np.asarray(mult)))
        active = jnp.ones((s,), jnp.float32)
        states = init_batched_fidelity_state(cfg, s)

        step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
        _, d_tot = timeit(step, states, audios, ends, tf, mult, limit, active)

        both = jnp.concatenate([ends, ends - interval], axis=1)
        ana = jax.jit(lambda au, en: jax.vmap(
            lambda a, e: analyse_frames(cfg, a, e))(au, en))
        specs, d_ana = timeit(ana, audios, both)
        cur = jnp.moveaxis(specs[:, :h], 1, 0)
        prev = jnp.moveaxis(specs[:, h:], 1, 0)
        pre = jax.jit(lambda st, c, p: chain_inputs_hops(
            cfg, st, c, p, tf, mult, limit))
        _, d_pre = timeit(pre, states[0], cur, prev)

        rest = d_tot - d_ana - d_pre
        agg = s * h * interval / SR / (d_tot / 1e3)
        rows.append((s, h, d_tot, d_ana, d_pre, rest, agg))
        print(f"S={s:4d} H={h:3d}  total {d_tot:8.2f}  analyses {d_ana:7.2f}"
              f"  chain_inputs {d_pre:7.2f}  chain+synth {rest:7.2f}"
              f"  -> {agg:.1f}x", flush=True)

    base = rows[0]
    print("\nscaling vs S=64 H=8 (per-stream-hop ratio; 1.00 = linear):")
    for s, h, d_tot, d_ana, d_pre, rest, _ in rows[1:]:
        k = (s * h) / (base[0] * base[1])
        print(f"S={s:4d} H={h:3d}  total {d_tot/base[2]/k:5.2f}"
              f"  analyses {d_ana/base[3]/k:5.2f}"
              f"  chain_inputs {d_pre/base[4]/k:5.2f}"
              f"  chain+synth {rest/base[5]/k:5.2f}", flush=True)


if __name__ == "__main__":
    main()
