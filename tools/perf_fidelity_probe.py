"""Throughput probe for the fidelity (blob-exact) engine.

Measures the batched hop step (64 streams, preset-default config) — the
spectral core's band scan is the sequential part; everything else is
batched FFT/elementwise.  Prints per-hop wall time and aggregate RTF.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from bauklank.engine.spectral import (
    SpectralConfig, init_spectral_state, spectral_hop,
)

S = 64          # streams
SR = 44100.0
cfg = SpectralConfig(channels=2, block=5292, interval=1323)
print(f"backend={jax.default_backend()} fft={cfg.fft} bands={cfg.bands} long_step={cfg.long_step}")

batched_state = jax.tree.map(
    lambda x: jnp.broadcast_to(x, (S,) + x.shape), init_spectral_state(cfg)
)

hop_v = jax.vmap(
    lambda st, si, sp, tf, mu, li: spectral_hop(cfg, st, si, sp, tf, mu, li),
    in_axes=(0, 0, 0, 0, 0, 0),
)


@jax.jit
def step(state, si, sp, tf, mu, li):
    state, out = hop_v(state, si, sp, tf, mu, li)
    # a scalar fence target
    return state, jnp.sum(jnp.abs(out) ** 2)


rng = np.random.default_rng(0)
si = jnp.asarray((rng.standard_normal((S, 2, cfg.bands)) + 1j * rng.standard_normal((S, 2, cfg.bands))).astype(np.complex64))
sp = jnp.asarray((rng.standard_normal((S, 2, cfg.bands)) + 1j * rng.standard_normal((S, 2, cfg.bands))).astype(np.complex64))
tf = jnp.full((S,), 2.0, jnp.float32)
mu = jnp.full((S,), 2.0 ** (5 / 12), jnp.float32)
li = jnp.full((S,), 0.13, jnp.float32)

t0 = time.time()
state, fence = step(batched_state, si, sp, tf, mu, li)
print(f"compile+first: {time.time()-t0:.1f}s fence={float(fence):.3f}")

n_iter = 20
t0 = time.time()
for _ in range(n_iter):
    state, fence = step(state, si, sp, tf, mu, li)
float(fence)
dt = (time.time() - t0) / n_iter
samples = S * cfg.interval
print(f"per-hop step: {dt*1e3:.2f} ms -> aggregate RTF {samples / SR / dt:.0f}x")
