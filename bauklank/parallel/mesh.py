"""Mesh construction and stream sharding.

The reference has no distributed anything (SURVEY.md §2.2) — its concurrency
is two browser worklets.  Scale-out here is over a ``jax.sharding.Mesh``:

- ``stream``: data parallelism over independent voices — zero collectives,
  the dominant axis for serving fleets.
- ``seq``: optional intra-stream sequence (hop) parallelism for very long
  offline renders — hops of one stream are spread over devices; the
  carried rotation product and the OLA boundary cross devices, handled in
  :func:`bauklank.parallel.seqpar.stretch_offline_sharded` with XLA
  collectives.

The serving steps run as one-device replicas: each device steps its own
streams with the single-device program (one jit, one executable per
device, no SPMD partitioning), so every stream's output is bit-identical
to the one-device step on the same block of streams, and no stream ever
moves between devices.  Both SPMD forms lose that: under a plain
NamedSharding jit the band-chain kernel (a custom call the partitioner
cannot split) would be replicated, gathering every stream onto every
device; under ``shard_map`` the partitioned module fuses differently, and
the blob's chaotic band chain grows the last-bit differences (measured on
four H100s: up to 1e-2 after 8 hops, PERF.md).  The mesh is built from the
devices as listed, with no topology assumption (the GPUs of one host are
joined all to all).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bauklank.engine.batched import batched_process_chunk

__all__ = [
    "stream_mesh", "shard_streams", "sharded_step", "sharded_fidelity_step",
    "sharded_live_fidelity_step",
]


def stream_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the ``stream`` axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), ("stream",))


def shard_streams(mesh: Mesh, tree):
    """Place a pytree with leading stream axes onto the mesh (stream-sharded)."""
    sharding = NamedSharding(mesh, P("stream"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def _stream_parallel(fn, mesh: Mesh):
    """Wrap ``fn`` (every argument and result stream-major) as one-device
    replicas over the ``stream`` axis of ``mesh``: arguments are placed
    stream-sharded, each device runs ``step.one`` (the jitted one-device
    ``fn``, states donated) on its own shard, and the results come back as
    stream-sharded global arrays."""
    devices = list(mesh.devices.flat)
    sharding = NamedSharding(mesh, P("stream"))
    one = jax.jit(fn, donate_argnums=(0,))

    def shard(x, device):
        return next(s.data for s in x.addressable_shards if s.device == device)

    def step(*args):
        args = jax.device_put(args, sharding)
        outs = [one(*jax.tree.map(lambda x: shard(x, d), args))
                for d in devices]

        def assemble(*parts):
            shape = (sum(p.shape[0] for p in parts),) + parts[0].shape[1:]
            return jax.make_array_from_single_device_arrays(
                shape, sharding, list(parts))

        return jax.tree.map(assemble, *outs)

    step.one = one
    step.devices = devices
    return step


def sharded_step(config, mesh: Mesh):
    """Compile the batched serving step with stream sharding over ``mesh``.

    Returns a function (states, audios, frame_ends, params) -> (states, out)
    where every argument and result is sharded on its leading stream axis.
    States are donated: steady-state serving does not reallocate.
    """
    return _stream_parallel(
        functools.partial(batched_process_chunk, config), mesh)


def sharded_fidelity_step(scfg, mesh: Mesh):
    """Compile the blob-exact fidelity pool step
    (:func:`bauklank.engine.fidelity.batched_fidelity_chunk`) with
    stream sharding over ``mesh``.

    Streams are pure data parallelism — zero collectives: every per-hop
    stage (MDFT analysis, chain-input precompute, the sequential band
    chain, synthesis OLA) is independent per stream, so hops of one stream
    stay on one device and the mesh spreads streams.  The hop axis inside
    the chunk is a lax.scan carried per shard (the band chain is
    order-dependent, reference processSpectrum
    app/SignalsmithStretch.mjs:826-954 — not shardable across hops).

    Returns ``step(states, audios, ends, tf, mult, limit, active, *fmt)``
    (``*fmt``: the three formant controls, with ``scfg.formants``) with
    every argument/result sharded on its leading stream axis and states
    donated.
    """
    from bauklank.engine.fidelity import batched_fidelity_chunk

    return _stream_parallel(
        functools.partial(batched_fidelity_chunk, scfg), mesh)


def sharded_live_fidelity_step(scfg, mesh: Mesh):
    """Compile the blob-exact COUPLED (live-input) step
    (:func:`bauklank.engine.fidelity.batched_live_fidelity_chunk`)
    with stream sharding over ``mesh``.

    Live voices are the purest stream-DP case: each voice carries its own
    input ring and consumes its own chunk (reference live branch
    app/SignalsmithStretch.mjs:870-882), so there are zero collectives —
    the mesh spreads voices and every stage stays on-device.

    Returns ``step(states, chunks, mult, limit, active, *fmt)`` (``*fmt``:
    the three formant controls, with ``scfg.formants``) with every
    argument/result sharded on its leading stream axis and states donated.
    ``chunks`` is ``[S, C, hops * scfg.interval]`` live input.
    """
    from bauklank.engine.fidelity import batched_live_fidelity_chunk

    return _stream_parallel(
        functools.partial(batched_live_fidelity_chunk, scfg), mesh)
