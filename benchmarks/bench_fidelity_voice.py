"""Single-voice fidelity RTF + fidelity-mode streaming p99 (VERDICT-r3
item 7: the two fidelity numbers configs 1-5 don't cover).

1. One voice through the public StretchNode(engine="fidelity") API —
   r2 measured 8.6x RT (goal >= 15x).  The hop-parallel chunk path now
   serves even a single stream, so H hops amortize each dispatch.
2. StreamPool(engine="fidelity") streaming step latency p50/p99 with the
   pipelined fetch, against the real-time budget (hops_per_step *
   interval worth of audio per step per voice).

Usage: PYTHONPATH=. python benchmarks/bench_fidelity_voice.py [steps]
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

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    print(f"device={jax.devices()[0]}", file=sys.stderr)
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))

    # ---- 1. single voice, public node API --------------------------------
    from bauklank.node import StretchNode

    t = np.arange(int(8 * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)).astype(
        np.float32
    )
    # hops_per_dispatch=16: bulk-pull mode — remainders below the smallest
    # bucket over-render one 16-hop dispatch into the FIFO instead of
    # paying one dispatch round trip per single-hop dispatch
    node = StretchNode(
        sample_rate=SR, channels=2, engine="fidelity", hops_per_dispatch=16)
    node.add_buffers([x, x])
    node.configure(blockMs=120.0, overlap=4.0, splitComputation=True)
    node.start(when=0.0, offset=0.0, rate=1.5, semitones=3)
    # warm EVERY pull-bucket graph (1024/256/64/16 hops): the node compiles
    # one graph per bucket size, and a cold bucket inside the timed pull
    # reads as a 10+ s "render" (this exact rig bug measured 0.1x once)
    interval = node.interval_samples
    for hops in (1024, 256, 64, 16):
        node.process_output(hops * interval)
    for seconds in (2.0, 8.0, 30.0):
        n_out = int(seconds * SR)
        t0 = time.perf_counter()
        out = node.process_output(n_out)
        float(np.abs(out).max())
        dt = time.perf_counter() - t0
        rtf = n_out / SR / dt
        print(
            f"single-voice fidelity (node API): {n_out/SR:.1f}s pull in "
            f"{dt*1e3:.0f} ms -> {rtf:.1f}x RT",
            file=sys.stderr,
        )

    # ---- 2. fidelity pool streaming p99 -----------------------------------
    from bauklank.serve.pool import StreamPool

    for s in (16, 64):
        pool = StreamPool(
            capacity=s, sample_rate=SR, engine="fidelity", max_track_sec=8.0,
            hops_per_step=8,
        )
        for i, slot in enumerate(pool.slots):
            pool.load_track(slot.name, [x, x])
            pool.start(slot.name, when=0.0, offset=0.0,
                       rate=0.5 + 1.5 * i / max(1, s - 1))
        pool.step(fetch=True)  # compile
        pool.timer.durations.clear()
        pool.timer.samples.clear()
        got = 0
        for _ in range(steps):
            master, _ = pool.step(fetch="pipeline")
            got += master is not None
        got += len(pool.drain())
        m = pool.metrics()
        budget_ms = pool.hops_per_step * pool.config.interval / SR * 1e3
        print(
            f"fidelity pool S={s} hops=8: p50 {m['p50_ms']:.1f} ms, "
            f"p99 {m['p99_ms']:.1f} ms (budget {budget_ms:.1f} ms/step, "
            f"pipelined, {got}/{steps} masters)",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
