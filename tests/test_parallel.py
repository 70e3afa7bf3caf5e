"""Batched + sharded serving step on a virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.util import tone

from bauklank.engine import StretchConfig, StretchParams
from bauklank.engine.batched import batched_process_chunk, init_batched_state
from bauklank.engine.offline import frame_ends_for
from bauklank.parallel import shard_streams, sharded_step, stream_mesh

SR = 44100.0
CFG = StretchConfig(channels=2, block=512, interval=128, formants=True)


def _setup(n_streams, t=12000, hops=16):
    rng = np.random.default_rng(0)
    audios = rng.standard_normal((n_streams, 2, t)).astype(np.float32) * 0.2
    rates = np.linspace(0.5, 2.0, n_streams)
    params = StretchParams.stack(
        [
            StretchParams.make(rate=r, semitones=s, sample_rate=SR)
            for r, s in zip(rates, np.linspace(-12, 12, n_streams))
        ]
    )
    ends = np.stack([frame_ends_for(CFG, 0, hops, r) for r in rates])
    states = init_batched_state(CFG, n_streams)
    return states, jnp.asarray(audios), jnp.asarray(ends, jnp.int32), params


def test_batched_matches_per_stream():
    from bauklank.engine.core import init_state, process_chunk

    states, audios, ends, params = _setup(4)
    _, out_b = batched_process_chunk(CFG, states, audios, ends, params)
    out_b = np.asarray(out_b)
    for i in range(4):
        st = init_state(CFG)
        p_i = jax.tree.map(lambda x: x[i], params)
        _, o = process_chunk(CFG, st, audios[i], ends[i], p_i)
        np.testing.assert_allclose(out_b[i], np.asarray(o), atol=1e-4)


def test_sharded_step_runs_on_8_device_mesh():
    assert jax.device_count() >= 8, jax.devices()
    mesh = stream_mesh(8)
    states, audios, ends, params = _setup(16)
    states, audios, ends, params = shard_streams(mesh, (states, audios, ends, params))
    step = sharded_step(CFG, mesh)
    new_states, out = step(states, audios, ends, params)
    assert out.shape == (16, 2, 16 * CFG.interval)
    # sharded across 8 devices on the stream axis
    assert len(out.sharding.device_set) == 8
    # a second step runs with the donated state
    ends2 = jnp.asarray(np.asarray(ends) + 16 * CFG.interval)
    ends2 = jax.device_put(ends2, out.sharding.spec and jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("stream")))
    _, out2 = step(new_states, audios, ends2, params)
    assert np.isfinite(np.asarray(out2)).all()


def test_sharded_matches_unsharded():
    mesh = stream_mesh(8)
    states, audios, ends, params = _setup(8)
    _, out_ref = batched_process_chunk(CFG, states, audios, ends, params)
    sh_args = shard_streams(mesh, (states, audios, ends, params))
    step = sharded_step(CFG, mesh)
    _, out_sh = step(*sh_args)
    np.testing.assert_allclose(np.asarray(out_ref), np.asarray(out_sh), atol=2e-4)


def test_fidelity_stream_sharded_matches_unsharded():
    """The blob-exact engine also shards over the stream axis: the batched
    fidelity chunk under a NamedSharding must match the unsharded result
    (multi-chip fidelity serving = pure data parallelism; the sequential
    band chain has no cross-stream dependence)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from bauklank.engine.fidelity import (
        SpectralConfig, batched_fidelity_chunk, init_batched_fidelity_state,
    )
    from bauklank.parallel import stream_mesh

    cfg = SpectralConfig(2, 512, 128)
    s_n = 8
    rng = np.random.default_rng(4)
    audios = jnp.asarray(rng.standard_normal((s_n, 2, 8000)).astype(np.float32) * 0.3)
    ends = jnp.asarray(
        np.stack([np.arange(1, 5) * cfg.interval + 600 + 37 * i for i in range(s_n)]),
        jnp.int32,
    )
    tf = jnp.asarray(np.linspace(0.8, 4.0, s_n), jnp.float32)
    mult = jnp.asarray(np.linspace(0.8, 1.4, s_n), jnp.float32)
    lim = jnp.full((s_n,), 0.2, jnp.float32)
    active = jnp.ones((s_n,), jnp.float32)
    states = init_batched_fidelity_state(cfg, s_n)

    _, out_ref = batched_fidelity_chunk(
        cfg, states, audios, ends, tf, mult, lim, active
    )

    mesh = stream_mesh(8)
    sh = NamedSharding(mesh, PartitionSpec("stream"))
    put = lambda tree: jax.tree.map(
        lambda x: jax.device_put(x, sh) if getattr(x, "ndim", 0) >= 1 else x, tree
    )
    states2 = init_batched_fidelity_state(cfg, s_n)
    _, out_sh = jax.jit(
        lambda st, au, en, t, m, l, a: batched_fidelity_chunk(
            cfg, st, au, en, t, m, l, a
        )
    )(put(states2), put(audios), put(ends), put(tf), put(mult), put(lim), put(active))
    assert len(out_sh.sharding.device_set) >= 1
    np.testing.assert_allclose(np.asarray(out_ref), np.asarray(out_sh), atol=2e-4)


def test_sharded_fidelity_step_matches_unsharded():
    """`parallel.mesh.sharded_fidelity_step` (explicit NamedSharding
    in/out + donated states, the serving-fleet compile path and dryrun
    stage 3) matches the unsharded chunk, formants engaged, across two
    donated steps."""
    from bauklank.engine.fidelity import (
        SpectralConfig, batched_fidelity_chunk, hop_frame_ends,
        init_batched_fidelity_state,
    )
    from bauklank.parallel import shard_streams, stream_mesh
    from bauklank.parallel.mesh import sharded_fidelity_step

    cfg = SpectralConfig(2, 512, 128, formants=True)
    s_n, h_n = 16, 3
    rng = np.random.default_rng(5)
    t = np.arange(9000) / SR
    audios = jnp.asarray(
        np.stack([
            np.stack([
                0.3 * np.sin(2 * np.pi * (220 + 5 * k + 3 * c) * t)
                for c in range(2)
            ])
            for k in range(s_n)
        ]).astype(np.float32)
        + 0.02 * rng.standard_normal((s_n, 2, 9000)).astype(np.float32)
    )
    rates = np.linspace(0.25, 2.0, s_n)  # includes the MINSTD regime
    ends = jnp.asarray(
        np.stack([
            hop_frame_ends(cfg, h_n, r, SR, input_offset=600.0 / SR)
            for r in rates
        ]),
        jnp.int32,
    )
    mult = np.exp2(np.linspace(-12, 12, s_n) / 12.0).astype(np.float32)
    args = (
        jnp.asarray((1.0 / rates).astype(np.float32)),
        jnp.asarray(mult),
        jnp.asarray(((8000.0 / SR) / np.sqrt(mult)).astype(np.float32)),
        jnp.ones((s_n,), jnp.float32),
        jnp.asarray(np.exp2(np.linspace(-5, 5, s_n) / 12.0), jnp.float32),
        jnp.asarray((np.arange(s_n) % 2).astype(np.float32)),
        jnp.zeros((s_n,), jnp.float32),  # auto f0
    )

    st_ref, out_ref = batched_fidelity_chunk(
        cfg, init_batched_fidelity_state(cfg, s_n), audios, ends, *args
    )

    mesh = stream_mesh(8)
    step = sharded_fidelity_step(cfg, mesh)
    sh_args = shard_streams(
        mesh, (init_batched_fidelity_state(cfg, s_n), audios, ends) + args
    )
    st_sh, out_sh = step(*sh_args)
    assert len(out_sh.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out_ref), np.asarray(out_sh), atol=2e-4)

    # second step with the donated state stays consistent with unsharded
    ends2 = shard_streams(mesh, jnp.asarray(np.asarray(ends) + cfg.interval))
    st_ref2, out_ref2 = batched_fidelity_chunk(
        cfg, st_ref, audios, jnp.asarray(np.asarray(ends) + cfg.interval), *args
    )
    _, out_sh2 = step(st_sh, sh_args[1], ends2, *sh_args[3:])
    np.testing.assert_allclose(
        np.asarray(out_ref2), np.asarray(out_sh2), atol=2e-4
    )


def test_sharded_live_fidelity_step_matches_unsharded():
    """`parallel.mesh.sharded_live_fidelity_step` (dryrun stage 4: the
    blob-exact COUPLED mode under stream-DP) matches the unsharded live
    chunk across two donated steps — live voices are pure data
    parallelism (each carries its own input ring; reference live branch
    app/SignalsmithStretch.mjs:870-882)."""
    from bauklank.engine.fidelity import (
        SpectralConfig, batched_live_fidelity_chunk,
        init_batched_live_fidelity_state,
    )
    from bauklank.parallel import shard_streams, stream_mesh
    from bauklank.parallel.mesh import sharded_live_fidelity_step

    cfg = SpectralConfig(2, 512, 128)
    s_n, h_n = 16, 2
    n = h_n * cfg.interval
    t = np.arange(2 * n) / SR
    chunks = [
        jnp.asarray(
            np.stack([
                np.stack([
                    0.3 * np.sin(2 * np.pi * (220 + 5 * k + 3 * c)
                                 * t[j * n:(j + 1) * n])
                    for c in range(2)
                ])
                for k in range(s_n)
            ]).astype(np.float32)
        )
        for j in range(2)
    ]
    mult = np.exp2(np.linspace(-12, 12, s_n) / 12.0).astype(np.float32)
    args = (
        jnp.asarray(mult),
        jnp.asarray(((8000.0 / SR) / np.sqrt(mult)).astype(np.float32)),
        jnp.ones((s_n,), jnp.float32),
    )

    st_ref = init_batched_live_fidelity_state(cfg, h_n, s_n)
    st_ref, out_ref = batched_live_fidelity_chunk(
        cfg, st_ref, chunks[0], *args)
    st_ref, out_ref2 = batched_live_fidelity_chunk(
        cfg, st_ref, chunks[1], *args)

    mesh = stream_mesh(8)
    step = sharded_live_fidelity_step(cfg, mesh)
    sh = shard_streams(
        mesh,
        (init_batched_live_fidelity_state(cfg, h_n, s_n), chunks[0]) + args,
    )
    st_sh, out_sh = step(*sh)
    assert len(out_sh.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out_ref), np.asarray(out_sh),
                               atol=2e-4)
    _, out_sh2 = step(st_sh, shard_streams(mesh, chunks[1]), *sh[2:])
    np.testing.assert_allclose(np.asarray(out_ref2), np.asarray(out_sh2),
                               atol=2e-4)


@pytest.mark.parametrize("live", [False, True])
def test_sharded_fidelity_steps_are_one_device_replicas(live):
    """Each device runs the one-device program on its own streams: the
    sharded result is bit-identical to the one-device step run block by
    block, over several hops (the carried band chain amplifies any
    last-bit difference), and the per-device program holds no collective."""
    import functools

    from bauklank.engine.fidelity import (
        SpectralConfig, batched_fidelity_chunk, batched_live_fidelity_chunk,
        init_batched_fidelity_state, init_batched_live_fidelity_state,
    )
    from bauklank.parallel import stream_mesh
    from bauklank.parallel.mesh import (
        sharded_fidelity_step, sharded_live_fidelity_step,
    )

    cfg = SpectralConfig(2, 512, 128)
    s_n, h_n, n_dev = 16, 3, 8
    per = s_n // n_dev
    mesh = stream_mesh(n_dev)
    rng = np.random.default_rng(11)
    rates = np.linspace(0.5, 2.0, s_n).astype(np.float32)
    mult = jnp.asarray(np.exp2(np.linspace(-7, 7, s_n) / 12).astype(np.float32))
    limit = jnp.full((s_n,), 0.18, jnp.float32)
    ones = jnp.ones((s_n,), jnp.float32)
    if live:
        step = sharded_live_fidelity_step(cfg, mesh)
        fn = functools.partial(batched_live_fidelity_chunk, cfg)
        args = (init_batched_live_fidelity_state(cfg, h_n, s_n),
                jnp.asarray((rng.standard_normal((s_n, 2, h_n * cfg.interval))
                             * 0.2).astype(np.float32)),
                mult, limit, ones)
        fresh = lambda n: init_batched_live_fidelity_state(cfg, h_n, n)
    else:
        step = sharded_fidelity_step(cfg, mesh)
        fn = functools.partial(batched_fidelity_chunk, cfg)
        ends = (700 + np.arange(h_n)[None] * cfg.interval
                * rates[:, None]).round().astype(np.int32)
        args = (init_batched_fidelity_state(cfg, s_n),
                jnp.asarray((rng.standard_normal((s_n, 2, 6000)) * 0.2
                             ).astype(np.float32)),
                jnp.asarray(ends), jnp.asarray(1.0 / rates), mult, limit,
                ones)
        fresh = lambda n: init_batched_fidelity_state(cfg, n)

    _, out = step(*args)
    assert len(out.sharding.device_set) == n_dev
    one = jax.jit(fn)
    blocks = np.concatenate([
        np.asarray(one(fresh(per), *(a[k * per:(k + 1) * per]
                                     for a in args[1:]))[1])
        for k in range(n_dev)])
    np.testing.assert_array_equal(np.asarray(out), blocks)

    shard0 = jax.tree.map(lambda x: jax.device_put(x[:per], mesh.devices.flat[0]),
                          (fresh(s_n),) + args[1:])
    hlo = step.one.lower(*shard0).compile().as_text()
    for collective in ("all-gather", "all-reduce", "all-to-all",
                       "collective-permute"):
        assert collective not in hlo, collective
