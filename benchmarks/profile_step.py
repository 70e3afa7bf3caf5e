"""Component timing for the 64-stream serving step (the bench.py shape).

Hot spots are located by timing jitted pieces of the step at exactly the
bench shapes and comparing their sum to the fused whole (a jax.profiler
trace of the card gives the same split per kernel).  Timing is fenced
with a jitted scalar reduction materialized via float().

Usage: PYTHONPATH=. python benchmarks/profile_step.py [reps]
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bauklank.engine import core as ec
    from bauklank.engine.batched import batched_process_chunk, init_batched_state
    from bauklank.engine.config import preset_default
    from bauklank.engine.offline import frame_ends_for
    from bauklank.engine.params import StretchParams
    from bauklank.ops import formant as formant_ops
    from bauklank.ops import framing, mdft, pitchmap

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    sr = 44100.0
    s, h = 64, 32
    config = preset_default(channels=2, sample_rate=sr)
    block, interval, bins = config.block, config.interval, config.bins
    print(f"device={jax.devices()[0]} block={block} interval={interval} "
          f"streams={s} hops={h}", file=sys.stderr)

    rng = np.random.default_rng(0)
    audios = jnp.asarray((rng.standard_normal((s, 2, int(6 * sr))) * 0.2).astype(np.float32))
    rates = np.linspace(0.5, 2.0, s)
    params = StretchParams.stack(
        [StretchParams.make(rate=r, semitones=m, sample_rate=sr)
         for r, m in zip(rates, np.linspace(-12, 12, s))])
    states = init_batched_state(config, s)
    ends = jnp.asarray(np.stack(
        [frame_ends_for(config, h * interval, h, r) for r in rates]), jnp.int32)

    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))

    def timeit(name, fn, *args):
        out = fn(*args)          # compile
        leaf = jax.tree.leaves(out)[0]
        float(fence(leaf))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        float(fence(jax.tree.leaves(out)[0]))
        dt = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:34s} {dt:8.2f} ms")
        return out

    # --- the fused whole (non-donating jit: the closure reuses `states`) ----
    full = jax.jit(functools.partial(batched_process_chunk, config))
    timeit("full step", lambda: full(states, audios, ends, params)[1])

    wa, ws, band_f = ec._window_consts(block, interval, config.window_beta)
    starts = jnp.concatenate([ends - block, ends - block - interval], axis=1)  # [S, 2H]

    # --- pieces -------------------------------------------------------------
    @jax.jit
    def frames_xla():
        def one(a, st):
            return framing.gather_frames(a, st, block) * wa
        return jax.vmap(one)(audios, starts)

    windowed = timeit("frame fetch (xla gather)", frames_xla)  # [S, C, 2H, B]

    spec = timeit("mdft fwd", jax.jit(lambda w: mdft.mdft(w) * ec._center_phase(bins)), windowed)

    limit = pitchmap.effective_tonality_limit(params.transpose_factor, params.tonality)

    @jax.jit
    def interp(sp):
        def one(spc, tf, lim):
            pos, _ = pitchmap.source_positions(jnp.asarray(band_f), tf, lim, block)
            return pitchmap.gather_fractional(spc, pos)
        return jax.vmap(one)(sp, params.transpose_factor, limit)

    specs_m = timeit("pitch interp gather", interp, spec)

    @jax.jit
    def rots(sp):
        v = pitchmap.unit(jnp.sum(sp[:, :, :h] * jnp.conj(sp[:, :, h:]), axis=1))
        reset = jnp.zeros(v.shape, bool)
        return jax.vmap(ec.rotation_scan)(states.rot, v, reset)

    rot_seq = timeit("factors+assoc scan", rots, specs_m)

    @jax.jit
    def synth(rseq, sp):
        out_spec = rseq[:, None] * sp[:, :, :h]
        out_spec = out_spec * jnp.conj(ec._center_phase(bins))
        out_frames = mdft.imdft(out_spec, block) * ws
        def one(fr_):
            return framing.overlap_add(fr_, interval, h * interval + block)
        return jax.vmap(one)(out_frames)

    timeit("imdft + overlap-add", synth, rot_seq, specs_m)

    @jax.jit
    def formants(sp):
        psum = jnp.sum(jnp.square(jnp.abs(sp)), axis=1)  # [S, 2H, bins]
        f0 = jax.vmap(formant_ops.detect_f0_bands)(psum)
        sigma = 0.5 * f0
        return jax.vmap(formant_ops.spectral_envelope)(psum, sigma)

    timeit("formant envelope chain", formants, spec)


if __name__ == "__main__":
    main()
