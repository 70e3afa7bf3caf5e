"""Fused ablation profile of the hoisted fidelity chain-inputs path (r4).

Isolated stage timings mislead on this attachment (documented r2/r3:
fusion changes the picture), so this rig times the FULL hoisted pipeline
jit-fused, then variants with ONE stage replaced by a same-shaped dummy;
the difference is that stage's fused marginal cost.  It also sweeps the
blockgather (t, chunk) choice per call site in the fused context.

The pipeline here is a faithful re-assembly of
`engine.spectral._hop_inputs_hoisted` from the same internals it calls
(no math duplicated — any drift would show as a wrong total vs
benchmarks/profile_fidelity.py's chain_inputs_hops line).

Usage: PYTHONPATH=. python benchmarks/profile_hoisted.py [S] [H] [regime]
  regime: "minstd" (default; tf=1000, generic blockgather path) or
          "det" (tf in [0.5, 2], the shared-window gather path —
          ops/windowgather — that the BASELINE matrix serves through)
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
        _find_peaks_map_batched,
        _hop_post_gather,
        _hop_pre_gather,
        _peaks_block_t,
        _smooth_bidirectional,
    )
    from bauklank.ops.blockgather import block_gather
    from bauklank.ops.windowgather import window_gather_taps, window_t1

    s_n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    regime = sys.argv[3] if len(sys.argv) > 3 else "minstd"
    block = round(0.12 * SR)
    interval = round(0.03 * SR)
    cfg = SpectralConfig(channels=2, block=block, interval=interval)
    b_n, fft, c_n = cfg.bands, cfg.fft, cfg.channels
    n = h * s_n
    t_blk = _peaks_block_t(b_n)
    print(
        f"device={jax.devices()[0]} S={s_n} H={h} B={b_n} t_blk={t_blk}",
        file=sys.stderr,
    )
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(o)))
    reps = 10

    def timeit(name, fn, *args):
        # every variant is wrapped to reduce its outputs to ONE real
        # scalar inside the jit (complex leaves cannot materialize on
        # this attachment; the reduction also keeps every output live
        # against DCE) — float() of the scalar is the fence (CLAUDE.md)
        def scalarized(*a):
            out = fn(*a)
            return sum(jnp.sum(jnp.abs(x)) for x in jax.tree.leaves(out))
        sfn = jax.jit(scalarized)
        float(sfn(*args))
        t0 = time.perf_counter()
        for _ in range(reps - 1):
            sfn(*args)
        float(sfn(*args))
        dt = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:52s} {dt:9.2f} ms   ({dt/h:6.2f} /hop)")
        return dt

    rng = np.random.default_rng(0)
    env = 0.02 + np.exp(
        -((np.arange(b_n) - b_n / 4.0) ** 2) / (2 * (b_n / 16.0) ** 2)
    )
    # complex64 cannot cross host<->device on this attachment: ship f32
    # re/im pairs and build complex on-device (CLAUDE.md)
    complexify = jax.jit(lambda p: jax.lax.complex(p[..., 0], p[..., 1]))
    cur = complexify(jnp.asarray(
        (rng.standard_normal((h, s_n, c_n, b_n, 2))
         * env[:, None]).astype(np.float32)))
    prev = complexify(jnp.asarray(
        (rng.standard_normal((h, s_n, c_n, b_n, 2))
         * env[:, None]).astype(np.float32)))
    seeds = jnp.asarray(rng.integers(1, 2 ** 31 - 1, (h, s_n)).astype(np.uint32))
    if regime == "det":  # BASELINE serving regime: shared-window gathers
        tf = jnp.asarray(np.linspace(0.5, 2.0, s_n).astype(np.float32))
    else:                # kiosk MINSTD regime: generic blockgather path
        tf = jnp.asarray(np.full(s_n, 1000.0, np.float32))
    mult = jnp.asarray(np.exp2(rng.uniform(-1, 1, s_n)).astype(np.float32))
    limit = jnp.full((s_n,), 8000.0 / SR, jnp.float32)

    coef = 1.0 / (0.5 * (fft / interval) + 1.0)

    def pipeline(cur, prev, seeds, tf, mult, limit,
                 stub_smooth=False, stub_peaks=False, stub_pre=False,
                 stub_five=False, stub_comb=False, stub_post=False,
                 t_five=None, c_five=8, t_peaks=None):
        t_f = t_five or t_blk
        energy_all = jnp.sum(jnp.square(jnp.abs(cur)), axis=2)
        e_flat = energy_all.reshape(n, b_n)
        if stub_smooth:
            sm = e_flat * 0.5
        else:
            sm, carry = _smooth_bidirectional(e_flat, coef, jnp.zeros((n,)))
            sm, _ = _smooth_bidirectional(sm, coef, carry)
        mult_n = jnp.broadcast_to(mult[None], (h, s_n)).reshape(n)
        limit_n = jnp.broadcast_to(limit[None], (h, s_n)).reshape(n)
        if stub_peaks:
            ib_m = jnp.broadcast_to(
                jnp.arange(b_n, dtype=jnp.float32)[None], (n, b_n))
            gr_m = jnp.ones((n, b_n), jnp.float32) * mult_n[:, None]
        else:
            ib_m, gr_m = _find_peaks_map_batched(
                e_flat, sm, mult_n, limit_n, b_n, fft,
                t_peaks or t_blk)
        peaks = (ib_m.reshape(h, s_n, b_n), gr_m.reshape(h, s_n, b_n))

        if stub_pre:
            spec_prev_rot = prev
            energy_c = jnp.square(jnp.abs(cur))
            input_bin, grad = peaks
            pos5 = jnp.concatenate(
                [input_bin + k for k in (-5.0, -1.0, 0.0, 1.0, 5.0)], axis=-1)
        else:
            pre = jax.vmap(
                jax.vmap(
                    lambda si, sp, sd, t, m, l, pk: _hop_pre_gather(
                        cfg, si, sp, sd, t, m, l, peaks=pk)),
                in_axes=(0, 0, 0, None, None, None, 0),
            )
            spec_prev_rot, energy_c, input_bin, grad, pos5 = pre(
                cur, prev, seeds, tf, mult, limit, peaks)

        def planes_of(z):
            p = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
            return jnp.moveaxis(p, 1, 2).reshape(n, b_n, 2 * c_n)

        def complex_of(p, k):
            q = p.reshape(n, k, c_n, 2)
            z = jax.lax.complex(q[..., 0], q[..., 1])
            return jnp.moveaxis(z, -1, 1).reshape(h, s_n, c_n, k)

        def weights(pos):
            i0 = jnp.floor(pos).astype(jnp.int32)
            frac = (pos - i0).astype(jnp.float32)
            ok0 = ((i0 >= 0) & (i0 < b_n)).astype(jnp.float32)
            ok1 = ((i0 + 1 >= 0) & (i0 + 1 < b_n)).astype(jnp.float32)
            return ok0 * (1.0 - frac), ok1 * frac

        if regime == "det" and not (stub_five or stub_comb):
            # ONE fused shared-window call serves all six families
            stepc = jnp.broadcast_to(
                jnp.clip(tf, 0.5, 2.0)[None, :], (h, s_n)).reshape(n)
            pos5_n = pos5.reshape(n, 5 * b_n)
            ib_n = input_bin.reshape(n, b_n)
            ga5, gb5, gac, gbc = window_gather_taps(
                planes_of(cur.reshape(n, c_n, b_n)),
                planes_of(spec_prev_rot.reshape(n, c_n, b_n)),
                jnp.moveaxis(energy_c.reshape(n, c_n, b_n), 1, 2),
                ib_n, pos5_n, stepc,
                long_step=cfg.long_step, t1=window_t1(b_n, cfg.long_step),
                chunk=8)
            w05, w15 = weights(pos5_n)
            w0c, w1c = weights(ib_n)
            five = complex_of(ga5 * w05[..., None] + gb5 * w15[..., None],
                              5 * b_n)
            g1 = gac * w0c[..., None] + gbc * w1c[..., None]
            prev_interp = complex_of(g1[..., : 2 * c_n], b_n)
            pe_raw = jnp.moveaxis(g1[..., 2 * c_n:], -1, 1).reshape(
                h, s_n, c_n, b_n)
        elif stub_five and stub_comb or (
                regime == "det" and (stub_five or stub_comb)):
            # det mode: the fused call serves both, so either stub drops it
            five = jnp.concatenate([cur] * 5, axis=-1)
            prev_interp = prev
            pe_raw = energy_c
        else:
            if stub_five:
                five = jnp.concatenate([cur] * 5, axis=-1)
            else:
                five_p = block_gather(
                    planes_of(cur.reshape(n, c_n, b_n)),
                    pos5.reshape(n, 5 * b_n), t=t_f, chunk=c_five)
                five = complex_of(five_p, 5 * b_n)

            if stub_comb:
                prev_interp = prev
                pe_raw = energy_c
            else:
                comb = jnp.concatenate(
                    [
                        planes_of(spec_prev_rot.reshape(n, c_n, b_n)),
                        jnp.moveaxis(energy_c.reshape(n, c_n, b_n), 1, 2),
                    ],
                    axis=-1,
                )
                g1 = block_gather(
                    comb, input_bin.reshape(n, b_n), t=t_f, chunk=c_five)
                prev_interp = complex_of(g1[..., : 2 * c_n], b_n)
                pe_raw = jnp.moveaxis(g1[..., 2 * c_n:], -1, 1).reshape(
                    h, s_n, c_n, b_n)

        if stub_post:
            return dict(tw=prev_interp * five[..., :b_n], pe=pe_raw)
        post = jax.vmap(
            jax.vmap(lambda f5, pe, pv, gr: _hop_post_gather(
                cfg, f5, pe, pv, gr)))
        return post(five, pe_raw, prev_interp, grad)

    import functools

    args = (cur, prev, seeds, tf, mult, limit)
    full = timeit("full hoisted pipeline", jax.jit(pipeline), *args)
    for stage in ("smooth", "peaks", "pre", "five", "comb", "post"):
        fn = jax.jit(functools.partial(pipeline, **{f"stub_{stage}": True}))
        dt = timeit(f"  - {stage} stubbed", fn, *args)
        print(f"{'':52s} -> {stage} marginal {full-dt:7.2f} ms "
              f"({(full-dt)/h:5.2f} /hop)", file=sys.stderr)

    if regime != "det":
        print("--- five-family (t, chunk) sweep in fused context ---")
        for t_f, c_f in [(8, 8), (8, 16), (16, 8), (16, 16), (32, 16), (4, 8)]:
            if b_n % t_f:
                continue
            fn = jax.jit(functools.partial(pipeline, t_five=t_f, c_five=c_f))
            timeit(f"  t_five={t_f} chunk={c_f}", fn, *args)

    print("--- peaks-internal gather t sweep in fused context ---")
    for t_p in (8, 16, 32, 64):
        if b_n % t_p:
            continue
        fn = jax.jit(functools.partial(pipeline, t_peaks=t_p))
        timeit(f"  t_peaks={t_p}", fn, *args)


if __name__ == "__main__":
    main()
