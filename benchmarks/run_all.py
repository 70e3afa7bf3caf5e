"""Run the five BASELINE benchmark configs; one JSON line per config.

BASELINE.md configs:
1. mono 44.1 kHz fixed 1.5x offline (CPU-runnable)  -> RTF + SNR vs refdsp
2. stereo continuous rate sweep 0.5-2.0x            -> RTF
3. stretch + pitch (+/-12 st) with formant bands    -> RTF
4. real-time streaming, 256-sample hops             -> p50/p99 step latency
5. batched 128-stream serving (64+ required)        -> aggregate RTF

Usage:  python benchmarks/run_all.py [--configs 1,2,3,4,5] [--quick]
Run alone (one process per card); first touch compiles for minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fence(x):
    import jax
    import jax.numpy as jnp

    return float(jax.jit(lambda o: jnp.sum(jnp.abs(o)))(x))


def _material(seconds, sr, channels, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 1318.5 * t)
    x = (x + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return np.stack([x * (1.0 - 0.3 * c) for c in range(channels)])


def config1(quick):
    """Mono fixed 1.5x offline; RTF + SNR vs the scalar reference renderer."""
    from bauklank.engine import StretchConfig, StretchParams, stretch_offline
    from bauklank.refdsp import render_offline

    sr = 44100.0
    cfg = StretchConfig(channels=1, block=1024, interval=256, formants=False)
    x = _material(2.0 if quick else 10.0, sr, 1)
    rate = 1.5
    n_out = int(x.shape[1] / rate)
    params = StretchParams.make(rate=rate, sample_rate=sr)
    # warm with identical shapes (compile + first-touch outside the timing)
    stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    t0 = time.perf_counter()
    got = stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    dt = time.perf_counter() - t0
    # SNR vs the independent scalar renderer on a prefix
    n_ref = min(n_out, 16384)
    want = render_offline(x.astype(np.float64), rate, cfg, n_ref)
    a, b = want[:, cfg.block:], got[:, cfg.block:n_ref]
    snr = 10 * np.log10(np.mean(a**2) / max(np.mean((a - b) ** 2), 1e-30))
    return {"config": 1, "metric": "offline_rtf", "value": round(n_out / sr / dt, 1),
            "unit": "x_realtime", "snr_db_vs_refdsp": round(float(snr), 1)}


def _offline_rtf(cfg_kw, params_kw, rate, channels, quick, config_id, sr=44100.0):
    from bauklank.engine import StretchConfig, StretchParams, stretch_offline

    cfg = StretchConfig(channels=channels, **cfg_kw)
    x = _material(2.0 if quick else 10.0, sr, channels)
    params = StretchParams.make(sample_rate=sr, **params_kw)
    n_out = int(x.shape[1] / rate)
    # warm with identical shapes (compile outside the timing)
    stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    t0 = time.perf_counter()
    out = stretch_offline(x, rate, cfg, params=params, n_out=n_out)
    dt = time.perf_counter() - t0
    assert np.isfinite(out).all()
    return {"config": config_id, "metric": "offline_rtf",
            "value": round(n_out / sr / dt, 1), "unit": "x_realtime"}


def config2(quick):
    """Stereo rate sweep 0.5->2.0 via the time map (node layer)."""
    from bauklank.engine.config import StretchConfig
    from bauklank.node import StretchNode

    sr = 44100.0
    x = _material(3.0 if quick else 12.0, sr, 2, seed=2)
    secs = 2.0 if quick else 8.0

    def run():
        node = StretchNode(sample_rate=sr, channels=2,
                           config=StretchConfig(channels=2, block=1024, interval=256),
                           hops_per_dispatch=16)
        node.add_buffers(list(x))
        node.start(when=0.0, offset=0.0, rate=0.5)
        for k in range(9):  # continuous-ish sweep 0.5 -> 2.0
            node.schedule({"output": k * secs / 8, "rate": 0.5 + 1.5 * k / 8})
        return node.process_output(int(secs * sr))

    run()  # warm: compiles every bucket this sweep uses
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    assert np.isfinite(out).all()
    return {"config": 2, "metric": "sweep_rtf", "value": round(secs / dt, 1),
            "unit": "x_realtime"}


def config3(quick):
    return {**_offline_rtf(
        dict(block=1024, interval=256, formants=True),
        dict(rate=0.8, semitones=12, formant_semitones=-3,
             formant_compensation=1.0, formant_base_hz=200.0),
        0.8, 2, quick, 3)}


def config4(quick):
    """Streaming at 256-sample hops: per-step latency p50/p99."""
    from bauklank.engine.config import StretchConfig
    from bauklank.serve.pool import StreamPool

    sr = 44100.0
    cfg = StretchConfig(channels=2, block=1024, interval=256, formants=False)
    pool = StreamPool(capacity=16, sample_rate=sr, config=cfg, max_track_sec=4.0,
                      hops_per_step=1)
    x = _material(3.0, sr, 2, seed=4)
    for s in pool.slots:
        pool.load_track(s.name, list(x))
        pool.start(s.name, when=0.0, offset=0.0, rate=0.7)
    pool.step(fetch=True)  # compile
    steps = 100 if quick else 400
    hop_ms = 256 / sr * 1e3
    # headline: pipelined per-step host fetch (step N dispatches + starts
    # its own d2h copy; the master from pipeline_depth steps back returns).
    # This is the serving loop's real shape — the transfer round trip is
    # hidden behind subsequent dispatches instead of serializing after each.
    pool.timer.durations.clear(); pool.timer.samples.clear()
    got = 0
    for _ in range(steps):
        master, _ = pool.step(fetch="pipeline")
        got += master is not None
    got += len(pool.drain())
    m = pool.metrics()
    # reference numbers: blocking per-step fetch + compute-only average
    pool.timer.durations.clear(); pool.timer.samples.clear()
    for _ in range(steps):
        pool.step(fetch=True)
    mb = pool.metrics()
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    for _ in range(steps):
        master, _ = pool.step()
    float(jax.jit(lambda o: jnp.sum(jnp.abs(o)))(master))
    avg_nofetch = (time.perf_counter() - t0) / steps * 1e3
    assert got == steps  # every pipelined master materializes exactly once
    return {"config": 4, "metric": "stream_step_p99_ms", "value": m["p99_ms"],
            "unit": "ms", "p50_ms": m["p50_ms"], "hop_ms": round(hop_ms, 2),
            "blocking_p99_ms": mb["p99_ms"], "blocking_p50_ms": mb["p50_ms"],
            "avg_step_ms_nofetch": round(avg_nofetch, 2),
            "pipeline_depth": pool.pipeline_depth,
            "realtime_ok": m["p99_ms"] < hop_ms * pool.capacity}


def config5(quick):
    """Batched serving aggregate RTF (the bench.py headline).

    128 streams: the measured per-chip throughput knee (64 -> 1783x,
    128 -> 2160x, 256 -> 2113x); BASELINE asks for 64+ streams."""
    import jax.numpy as jnp

    from bauklank.engine.batched import batched_step_jit, init_batched_state
    from bauklank.engine.config import preset_default
    from bauklank.engine.offline import frame_ends_for
    from bauklank.engine.params import StretchParams

    sr = 44100.0
    s, h = 128, 32
    config = preset_default(channels=2, sample_rate=sr)
    # formant-neutral params -> the serving pool dispatches the
    # formants-off compile (see serve/pool.StreamPool.step); measure that
    from bauklank.engine.batched import formants_off

    config = formants_off(config)
    rng = np.random.default_rng(5)
    audios = jnp.asarray((rng.standard_normal((s, 2, int(4 * sr))) * 0.2).astype(np.float32))
    rates = np.linspace(0.5, 2.0, s)
    params = StretchParams.stack(
        [StretchParams.make(rate=r, semitones=m, sample_rate=sr)
         for r, m in zip(rates, np.linspace(-12, 12, s))])
    states = init_batched_state(config, s)

    def ends(i):
        return jnp.asarray(np.stack(
            [frame_ends_for(config, i * h * config.interval, h, r) for r in rates]), jnp.int32)

    states, out = batched_step_jit(config, states, audios, ends(0), params)
    _fence(out)
    steps = 4 if quick else 8
    pre = [ends(i) for i in range(1, steps + 1)]  # host work outside the loop
    t0 = time.perf_counter()
    for i in range(steps):
        states, out = batched_step_jit(config, states, audios, pre[i], params)
    _fence(out)
    dt = time.perf_counter() - t0
    rtf = steps * s * h * config.interval / dt / sr
    return {"config": 5, "metric": "aggregate_realtime_factor",
            "value": round(rtf, 1), "unit": "x_realtime_per_chip"}


def main():
    import jax

    # persistent compile cache (same as bench.py)
    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for c in [int(x) for x in args.configs.split(",")]:
        log(f"--- config {c} ---")
        t0 = time.perf_counter()
        res = fns[c](args.quick)
        log(f"config {c} took {time.perf_counter()-t0:.1f}s")
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
