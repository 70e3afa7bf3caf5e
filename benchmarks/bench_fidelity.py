"""Headline bench for the BLOB-EXACT serving path (BASELINE's conjunctive
row: >=500x aggregate AND >=40 dB vs the reference renderer from ONE
path).  Mirrors bench.py's contract — ONE JSON line on stdout — but
drives StreamPool(engine="fidelity") at the preset serving config over
the BASELINE rate/pitch matrix (rates 0.5-2.0, +/-12 st: the >=40 dB
domain, all deterministic-step regime).

Usage: PYTHONPATH=. python benchmarks/bench_fidelity.py [streams] [hops]
Needs a GPU.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np

SR = 44100.0
BASELINE_TARGET = 500.0


def main():
    import jax
    import jax.numpy as jnp

    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    s = int(args[0]) if len(args) > 0 else 128
    h = int(args[1]) if len(args) > 1 else 8
    reps = 12

    from bauklank.engine.fidelity import (
        SpectralConfig,
        batched_fidelity_chunk,
        init_batched_fidelity_state,
    )

    block = round(0.12 * SR)
    interval = round(0.03 * SR)
    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    print(
        f"device={jax.devices()[0]} streams={s} hops={h} "
        f"block={block}/{interval}", file=sys.stderr,
    )

    rng = np.random.default_rng(0)
    audios = jnp.asarray(
        (rng.standard_normal((s, 2, int(6 * SR))) * 0.2).astype(np.float32))
    rates = np.linspace(0.5, 2.0, s).astype(np.float32)
    ends = jnp.asarray(
        600 + block
        + (np.arange(h)[None] * interval * rates[:, None]).round().astype(
            np.int32))
    tf = jnp.asarray(1.0 / rates)
    mult = jnp.asarray(np.exp2(np.linspace(-12, 12, s) / 12).astype(np.float32))
    limit = jnp.asarray((8000.0 / SR) / np.sqrt(np.asarray(mult)))
    active = jnp.ones((s,), jnp.float32)
    states = init_batched_fidelity_state(cfg, s)

    step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))
    t0 = time.time()
    out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    print(f"compiled+warm in {time.time()-t0:.0f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    dt = (time.perf_counter() - t0) / reps
    agg = s * h * interval / SR / dt
    print(
        f"{reps} steps, {dt*1e3:.2f} ms/step -> {agg:.1f}x realtime "
        f"aggregate (blob-exact engine)", file=sys.stderr,
    )
    line = {
        "metric": "fidelity_aggregate_realtime_factor",
        "value": round(agg, 2),
        "unit": "x_realtime_per_chip_blob_exact",
        "vs_baseline": round(agg / BASELINE_TARGET, 4),
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
