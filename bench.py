"""Headline benchmark: the CONJUNCTIVE BASELINE reading, one JSON line.

- ``value``: aggregate real-time factor of the BLOB-EXACT serving path
  (StreamPool fidelity step, BASELINE matrix rates 0.5-2.0 x +/-12 st at
  the preset serving geometry) — the number that pairs with the >=40 dB
  row, whose on-card golden floor rides along as ``snr_floor_db`` (read
  from the ``GOLDEN_<device>.json`` artifact of the device this runs on,
  which ``benchmarks/check_golden.py --all --record`` writes; null when
  there is none).
- ``fast_x``: the fast engine's aggregate (128 streams, 32 hops,
  preset-default, BASELINE config 5 shape).
- ``kiosk_x``: the blob-exact aggregate at the DEPLOYED kiosk operating
  point — blockMs=200, overlap=1.0 (interval == block), rate 0.001
  (reference app/multi/app.mjs:113,124-130) — the tf>2 MINSTD regime.
- ``device`` and ``power_limit_w``: the card, as JAX and nvidia-smi
  name it.

vs_baseline = value / 500 (the driver-set >=500x target, BASELINE.md).

Needs a GPU (exits non-zero without one).  Timed regions end in a
device-to-host read of a jitted reduction; compilation is excluded.
Logs go to stderr; stdout is exactly one JSON line.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys
import time

import numpy as np

SR = 44100.0
BASELINE_TARGET = 500.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_fast():
    """The fast engine's aggregate RTF (BASELINE config 5 shape)."""
    import jax
    import jax.numpy as jnp

    from bauklank.engine.batched import (
        batched_step_jit, formants_off, init_batched_state,
    )
    from bauklank.engine.config import preset_default
    from bauklank.engine.offline import frame_ends_for
    from bauklank.engine.params import StretchParams

    n_streams = 128
    hops = 32
    # the serving pool dispatches the formants-off compile of the step when
    # no stream uses formant controls (serve/pool.StreamPool.step; the
    # reference engine gates the same way) — this bench's params are
    # formant-neutral, so measure that path
    config = formants_off(preset_default(channels=2, sample_rate=SR))
    log(f"[fast] config=block{config.block}/int{config.interval} streams={n_streams}")

    rng = np.random.default_rng(0)
    t = int(6 * SR)
    audios = jnp.asarray(
        (rng.standard_normal((n_streams, 2, t)) * 0.2).astype(np.float32))
    rates = np.linspace(0.5, 2.0, n_streams)
    params = StretchParams.stack(
        [
            StretchParams.make(rate=r, semitones=s, sample_rate=SR)
            for r, s in zip(rates, np.linspace(-12, 12, n_streams))
        ]
    )
    states = init_batched_state(config, n_streams)
    rms_jit = jax.jit(lambda o: jnp.sqrt(jnp.mean(jnp.square(o))))

    def ends_at(step_idx):
        return jnp.asarray(
            np.stack(
                [frame_ends_for(config, step_idx * hops * config.interval,
                                hops, r) for r in rates]
            ),
            jnp.int32,
        )

    t0 = time.perf_counter()
    states, out = batched_step_jit(config, states, audios, ends_at(0), params)
    rms = float(rms_jit(out))
    assert np.isfinite(rms) and rms > 0, rms
    log(f"[fast] compiled+warm in {time.perf_counter()-t0:.0f}s, rms={rms:.4f}")

    n_steps = 8
    ends = [ends_at(i + 1) for i in range(n_steps)]
    t0 = time.perf_counter()
    for i in range(n_steps):
        states, out = batched_step_jit(config, states, audios, ends[i], params)
    float(rms_jit(out))  # fence
    dt = time.perf_counter() - t0
    rtf = n_steps * n_streams * hops * config.interval / dt / SR
    log(f"[fast] {n_steps} steps in {dt:.3f}s -> {rtf:.1f}x aggregate")
    return rtf


def bench_fidelity(s, h, block, interval, rates, reps=12, tag="fidelity"):
    """Blob-exact StreamPool-form step over a rate mix; returns aggregate
    RTF.  Mirrors benchmarks/bench_fidelity.py."""
    import jax
    import jax.numpy as jnp

    from bauklank.engine.fidelity import (
        SpectralConfig,
        batched_fidelity_chunk,
        init_batched_fidelity_state,
    )

    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    log(f"[{tag}] streams={s} hops={h} block={block}/{interval} "
        f"rates {rates.min():g}..{rates.max():g}")

    rng = np.random.default_rng(0)
    audios = jnp.asarray(
        (rng.standard_normal((s, 2, int(6 * SR))) * 0.2).astype(np.float32))
    ends = jnp.asarray(
        600 + block
        + (np.arange(h)[None] * interval * rates[:, None]).round().astype(
            np.int32))
    # blob seek law: tf saturates at `interval` once rate < 1/interval
    tf = jnp.asarray(np.minimum(1.0 / rates, float(interval)).astype(np.float32))
    mult = jnp.asarray(np.exp2(np.linspace(-12, 12, s) / 12).astype(np.float32))
    limit = jnp.asarray((8000.0 / SR) / np.sqrt(np.asarray(mult)))
    active = jnp.ones((s,), jnp.float32)
    states = init_batched_fidelity_state(cfg, s)

    step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))
    t0 = time.time()
    out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    log(f"[{tag}] compiled+warm in {time.time()-t0:.0f}s")

    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(states, audios, ends, tf, mult, limit, active)
    float(fence(jax.tree.leaves(out)[0]))
    dt = (time.perf_counter() - t0) / reps
    agg = s * h * interval / SR / dt
    log(f"[{tag}] {dt*1e3:.2f} ms/step -> {agg:.1f}x aggregate")
    return agg


def main():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "benchmarks"))
    from check_golden import golden_floor

    from bauklank.utils.compile_cache import (
        card_line, enable_compile_cache, power_limit_w, require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    card = card_line()
    log(f"device={device.device_kind} card={card}")

    # 1. blob-exact serving aggregate (the conjunctive headline): the
    #    BASELINE >=40 dB matrix at the preset serving geometry, 128 streams
    fid_x = bench_fidelity(
        128, 8, round(0.12 * SR), round(0.03 * SR),
        np.linspace(0.5, 2.0, 128).astype(np.float32))

    # 2. the deployed kiosk operating point: blockMs=200/overlap=1.0 at
    #    rate 0.001 (tf > 2: MINSTD regime + overlap-1 geometry)
    kiosk_x = bench_fidelity(
        64, 4, round(0.2 * SR), round(0.2 * SR),
        np.full(64, 0.001, np.float32), reps=8, tag="kiosk")

    # 3. the fast engine
    fast_x = bench_fast()

    print(
        json.dumps(
            {
                "metric": "fidelity_aggregate_realtime_factor",
                "value": round(fid_x, 2),
                "unit": "x_realtime_per_gpu_blob_exact",
                "vs_baseline": round(fid_x / BASELINE_TARGET, 4),
                "fast_x": round(fast_x, 2),
                "kiosk_x": round(kiosk_x, 2),
                "snr_floor_db": golden_floor(device.device_kind),
                "device": device.device_kind,
                "power_limit_w": power_limit_w(card),
            }
        )
    )


if __name__ == "__main__":
    main()
