"""Perf battery: the blob-exact serving standings in one process.

The two-measurement rule (CLAUDE.md) needs a cheap way to re-measure the
standing serving shapes in one bounded run.  This battery measures, in ONE
process on the card:

- standings: the blob-exact serving aggregate over the S x H grid
  (64/8, 128/8, 128/16, 256/8), BASELINE rates 0.5-2.0 (deterministic-step
  regime);
- regimes: the SAME shapes at rate < 0.5 mixes (tf > 2: MINSTD draws
  active, windowgather fallback cond) and the deployed kiosk operating
  point (blockMs=200, overlap=1.0, rate 0.001 — reference
  app/multi/app.mjs:124-130).

Usage:
    python benchmarks/battery.py

Needs a GPU.  Stderr carries the human table; stdout one JSON object.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys
import time

import numpy as np

SR = 44100.0
REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(s, h, block, interval, rates, reps=10):
    """One blob-exact serving measurement; returns aggregate RTF."""
    import jax
    import jax.numpy as jnp

    from bauklank.engine.fidelity import (
        SpectralConfig, batched_fidelity_chunk, init_batched_fidelity_state,
    )

    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    rng = np.random.default_rng(0)
    audios = jnp.asarray(
        (rng.standard_normal((s, 2, int(6 * SR))) * 0.2).astype(np.float32))
    ends = jnp.asarray(
        600 + block
        + (np.arange(h)[None] * interval * rates[:, None]).round().astype(
            np.int32))
    # blob seek law: tf saturates at `interval` (rate < 1/interval)
    tf = jnp.asarray(
        np.minimum(1.0 / rates, float(interval)).astype(np.float32))
    mult = jnp.asarray(
        np.exp2(np.linspace(-12, 12, s) / 12).astype(np.float32))
    limit = jnp.asarray((8000.0 / SR) / np.sqrt(np.asarray(mult)))
    active = jnp.ones((s,), jnp.float32)
    states = init_batched_fidelity_state(cfg, s)

    step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))
    t0 = time.time()
    out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    warm = time.time() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    dt = (time.perf_counter() - t0) / reps
    agg = s * h * interval / SR / dt
    log(f"    warm {warm:.0f}s, {dt * 1e3:.2f} ms/step -> {agg:.1f}x")
    return round(agg, 1)


def main():
    from bauklank.utils.compile_cache import (
        card_line, enable_compile_cache, require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    card = card_line()
    log(f"device={device.device_kind} card={card}")

    blk, itv = round(0.12 * SR), round(0.03 * SR)
    kblk = round(0.2 * SR)
    det = lambda s: np.linspace(0.5, 2.0, s).astype(np.float32)
    ext = lambda s: np.geomspace(0.02, 0.45, s).astype(np.float32)

    rows = {}

    log("[standings: rates 0.5-2.0, preset geometry]")
    for s, h in ((64, 8), (128, 8), (128, 16), (256, 8)):
        log(f"  S={s} H={h}")
        rows[f"det_s{s}_h{h}"] = measure(s, h, blk, itv, det(s))

    log("[tf>2 regime: rates 0.02-0.45 (MINSTD active)]")
    for s, h in ((64, 8), (128, 8)):
        log(f"  S={s} H={h}")
        rows[f"tf2_s{s}_h{h}"] = measure(s, h, blk, itv, ext(s))

    log("[kiosk operating point: 200ms/overlap-1, rate 0.001]")
    rows["kiosk_s64_h4"] = measure(
        64, 4, kblk, kblk, np.full(64, 0.001, np.float32), reps=8)

    print(json.dumps({"rows": rows, "device": device.device_kind,
                      "card": card}))


if __name__ == "__main__":
    main()
