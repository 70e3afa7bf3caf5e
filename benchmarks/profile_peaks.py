"""Micro-decomposition of _find_peaks_map_batched on the attached device.

Times each constituent at the serving shape (N = S*H examples, B bands):
the run-id cumsums, the 2-payload f32 segment scatter, the int histogram
scatter, the blockgather rank lookup, and the elementwise map tail —
plus candidate replacements (sort-based boundary compaction, one-hot
searchsorted) so the scatter-free redesign can be chosen from data.

Usage: PYTHONPATH=. python benchmarks/profile_peaks.py [S] [H]
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

    from bauklank.engine.spectral import SpectralConfig
    from bauklank.ops.blockgather import block_gather

    s = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    cfg = SpectralConfig(channels=2, block=round(0.12 * SR),
                         interval=round(0.03 * SR))
    b_n, fft = cfg.bands, cfg.fft
    n = s * h
    print(f"device={jax.devices()[0]} N={n} B={b_n}", file=sys.stderr)
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(jnp.asarray(o, jnp.float32))))
    reps = 8

    def timeit(name, fn, *args):
        out = fn(*args)
        float(fence(jax.tree.leaves(out)[0]))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        float(fence(jax.tree.leaves(out)[0]))
        dt = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:46s} {dt:9.2f} ms  ({dt/h:6.2f} /hop)")
        return out

    rng = np.random.default_rng(0)
    energy = jnp.asarray(np.abs(rng.standard_normal((n, b_n))).astype(np.float32))
    sm = jnp.asarray(np.abs(rng.standard_normal((n, b_n))).astype(np.float32) * 0.8)

    @jax.jit
    def runids(e, smv):
        above = e > smv
        prev_above = jnp.concatenate([jnp.zeros_like(above[:, :1]), above[:, :-1]], 1)
        run_start = above & ~prev_above
        run_id = jnp.cumsum(run_start.astype(jnp.int32), 1) * above.astype(jnp.int32)
        return above, run_id

    above, run_id = timeit("cumsum run ids", runids, energy, sm)
    seg = jnp.where(above, run_id - 1, b_n - 1)
    w = jnp.where(above, energy, 0.0)
    b_idx = jnp.arange(b_n, dtype=jnp.float32)

    @jax.jit
    def seg_scatter(sg, payload):
        return jax.vmap(lambda g, p: jnp.zeros((b_n, 2), jnp.float32).at[g].add(p))(
            sg, payload)

    payload = jnp.stack([w, w * b_idx[None]], axis=-1)
    timeit("segment scatter (2-payload f32)", seg_scatter, seg, payload)

    j = jnp.asarray(rng.integers(0, b_n + 1, (n, b_n)).astype(np.int32))
    valid = jnp.asarray((rng.random((n, b_n)) < 0.1))

    @jax.jit
    def hist_scatter(jj, vv):
        return jax.vmap(lambda a, b: jnp.zeros((b_n + 1,), jnp.int32).at[a].add(
            b.astype(jnp.int32)))(jj, vv)

    timeit("histogram scatter (int32)", hist_scatter, j, valid)

    ranks = jnp.asarray(
        np.sort(rng.integers(0, b_n, (n, 2 * b_n))).astype(np.float32))
    vals = jnp.asarray(rng.standard_normal((n, b_n, 2)).astype(np.float32))
    t_blk = next((t for t in (64, 32, 16, 8) if b_n % t == 0), 64)

    @jax.jit
    def bg(v, r):
        return block_gather(v, r, t=t_blk)

    timeit("blockgather ranks (2B x 2)", bg, vals, ranks)

    # --- candidate replacements ------------------------------------------
    @jax.jit
    def cumsums(e, smv):
        above = e > smv
        wv = jnp.where(above, e, 0.0)
        cs = jnp.cumsum(jnp.stack([wv, wv * b_idx[None]], -1), axis=1)
        return cs

    timeit("2-payload cumsum (replacement core)", cumsums, energy, sm)

    @jax.jit
    def sort_compact(e, smv):
        above = e > smv
        prev_above = jnp.concatenate([jnp.zeros_like(above[:, :1]), above[:, :-1]], 1)
        nxt_above = jnp.concatenate([above[:, 1:], jnp.zeros_like(above[:, :1])], 1)
        is_start = above & ~prev_above
        is_end = above & ~nxt_above
        big = jnp.int32(b_n)
        key_s = jnp.where(is_start, jnp.arange(b_n, dtype=jnp.int32), big)
        key_e = jnp.where(is_end, jnp.arange(b_n, dtype=jnp.int32), big)
        return jnp.sort(key_s, axis=1), jnp.sort(key_e, axis=1)

    timeit("sort-compaction of run boundaries (x2)", sort_compact, energy, sm)

    out_slots = jnp.asarray(
        np.sort(rng.standard_normal((n, b_n)).astype(np.float32)) * b_n)

    @jax.jit
    def searchsorted_mm(slots):
        # idx[b] = #(slots <= b) via chunked one-hot comparisons as matmuls
        import jax.numpy as jnp2
        def chunk(sl):
            cmp = (sl[:, :, None] <= b_idx[None, None, :]).astype(jnp.float32)
            return jnp.einsum("nsb->nb", cmp)
        return jax.lax.map(chunk, slots.reshape(-1, 16, b_n)).reshape(n, b_n)

    timeit("searchsorted via compare-sum (chunked)", searchsorted_mm, out_slots)


if __name__ == "__main__" and (len(sys.argv) <= 3):
    main()


def extra():
    """Collision-structure experiments for the segment scatter."""
    import jax
    import jax.numpy as jnp
    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import sys, time
    import numpy as np
    from bauklank.engine.spectral import SpectralConfig
    s = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    cfg = SpectralConfig(channels=2, block=round(0.12*SR), interval=round(0.03*SR))
    b_n = cfg.bands
    n = s*h
    fence = jax.jit(lambda o: jnp.sum(jnp.abs(jnp.asarray(o, jnp.float32))))
    reps = 8
    def timeit(name, fn, *args):
        out = fn(*args); float(fence(jax.tree.leaves(out)[0]))
        t0 = time.perf_counter()
        for _ in range(reps): out = fn(*args)
        float(fence(jax.tree.leaves(out)[0]))
        dt = (time.perf_counter()-t0)/reps*1e3
        print(f"{name:46s} {dt:9.2f} ms  ({dt/h:6.2f} /hop)")
        return out
    rng = np.random.default_rng(0)
    energy = jnp.asarray(np.abs(rng.standard_normal((n, b_n))).astype(np.float32))
    sm = jnp.asarray(np.abs(rng.standard_normal((n, b_n))).astype(np.float32)*0.8)
    above = np.asarray(energy) > np.asarray(sm)
    run_start = above & ~np.concatenate([np.zeros((n,1),bool), above[:,:-1]],1)
    run_id = np.cumsum(run_start.astype(np.int32),1)*above.astype(np.int32)
    b_idx = np.arange(b_n, dtype=np.float32)
    w = np.where(above, np.asarray(energy), 0.0)
    payload = jnp.asarray(np.stack([w, w*b_idx[None]], -1))
    seg_parkone = jnp.asarray(np.where(above, run_id-1, b_n-1).astype(np.int32))
    seg_parkunique = jnp.asarray(np.where(above, run_id-1, b_n + b_idx.astype(np.int32)).astype(np.int32))
    rand_unique = jnp.asarray(np.argsort(rng.random((n, b_n)), axis=1).astype(np.int32))

    @jax.jit
    def scat_one(sg, p):
        return jax.vmap(lambda g, q: jnp.zeros((b_n,2), jnp.float32).at[g].add(q))(sg, p)
    @jax.jit
    def scat_unique(sg, p):
        return jax.vmap(lambda g, q: jnp.zeros((2*b_n,2), jnp.float32).at[g].add(q))(sg, p)[:, :b_n]
    @jax.jit
    def scat_rand(sg, p):
        return jax.vmap(lambda g, q: jnp.zeros((b_n,2), jnp.float32).at[g].add(q))(sg, p)
    @jax.jit
    def scat_set_unique(sg, p):
        # parked-unique indices are collision-free only for the park region;
        # real segments still need add
        return jax.vmap(lambda g, q: jnp.zeros((2*b_n,2), jnp.float32).at[g].add(q,
                 indices_are_sorted=False, unique_indices=False))(sg, p)[:, :b_n]

    timeit("segment scatter park-ONE (baseline)", scat_one, seg_parkone, payload)
    timeit("segment scatter park-UNIQUE", scat_unique, seg_parkunique, payload)
    timeit("scatter all-unique random (no collisions)", scat_rand, rand_unique, payload)


if __name__ == "__main__" and len(sys.argv) > 3 and sys.argv[3] == "extra":
    extra()
