"""Fidelity-engine serving profile (VERDICT r2 item 1 measurement rig).

Times the blob-exact serving path at the preset shape (block 5292 /
interval 1323, stereo 44.1 kHz) on whatever device is attached:

- device-only step time of the hop-parallel `batched_fidelity_chunk`
  (round 3) vs the original hop-scan form, at several (streams, hops);
- stage decomposition of the hop-parallel form: analyses /
  chain_inputs_hops (the batched hop-local precompute) / the light
  sequential scan + bandchain kernel / synthesis+OLA;
- StreamPool.step wall time (includes host packing + h2d).

Timing is fenced with a jitted scalar reduction materialized via float()
(block_until_ready is unreliable on this attachment path — CLAUDE.md).

Usage: PYTHONPATH=. python benchmarks/profile_fidelity.py [reps]
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
        batched_fidelity_chunk_scan,
        init_batched_fidelity_state,
    )
    from bauklank.engine.spectral import chain_inputs_hops

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    block = round(0.12 * SR)
    interval = round(0.03 * SR)
    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    print(
        f"device={jax.devices()[0]} block={block} interval={interval} "
        f"fft={cfg.fft} bands={cfg.bands} long_step={cfg.long_step}",
        file=sys.stderr,
    )
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))

    def timeit(name, fn, *args):
        out = fn(*args)  # compile
        float(fence(jax.tree.leaves(out)[0].real))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        float(fence(jax.tree.leaves(out)[0].real))
        dt = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:44s} {dt:9.2f} ms")
        return out, dt

    rng = np.random.default_rng(0)

    def inputs(s, h):
        audios = jnp.asarray(
            (rng.standard_normal((s, 2, int(6 * SR))) * 0.2).astype(np.float32)
        )
        rates = np.linspace(0.5, 2.0, s).astype(np.float32)
        ends = jnp.asarray(
            600
            + block
            + (np.arange(h)[None] * interval * rates[:, None]).round().astype(
                np.int32
            )
        )
        tf = jnp.asarray(1.0 / rates)
        mult = jnp.asarray(
            np.exp2(np.linspace(-12, 12, s) / 12).astype(np.float32)
        )
        limit = jnp.asarray((8000.0 / SR) / np.sqrt(np.asarray(mult)))
        active = jnp.ones((s,), jnp.float32)
        states = init_batched_fidelity_state(cfg, s)
        return states, audios, ends, tf, mult, limit, active

    for s, h in [(16, 8), (64, 8), (64, 16), (64, 32), (128, 8), (128, 16),
                 (256, 8), (256, 16)]:
        states, audios, ends, tf, mult, limit, active = inputs(s, h)
        args = (states, audios, ends, tf, mult, limit, active)
        step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
        _, dt = timeit(f"hop-parallel S={s} H={h}", lambda: step(*args))
        rt = s * h * interval / SR / (dt / 1e3)
        print(f"{'':44s} -> aggregate {rt:.1f}x RT", file=sys.stderr)
        if h == 8 and s in (16, 64):
            scan_step = jax.jit(
                functools.partial(batched_fidelity_chunk_scan, cfg)
            )
            timeit(f"hop-scan (r2 form) S={s} H={h}", lambda: scan_step(*args))

    # ---- stage decomposition at the serving point -------------------------
    s, h = 64, 16
    states, audios, ends, tf, mult, limit, active = inputs(s, h)
    both = jnp.concatenate([ends, ends - interval], axis=1)

    ana = jax.jit(
        lambda au, en: jax.vmap(lambda a, e: analyse_frames(cfg, a, e))(au, en)
    )
    specs, _ = timeit(f"analyses S={s} H={h}", ana, audios, both)
    cur = jnp.moveaxis(specs[:, :h], 1, 0)
    prev = jnp.moveaxis(specs[:, h:], 1, 0)

    pre = jax.jit(
        lambda st, c, p: chain_inputs_hops(cfg, st, c, p, tf, mult, limit)
    )
    timeit(f"chain_inputs_hops S={s} H={h}", pre, states[0], cur, prev)


if __name__ == "__main__":
    main()
