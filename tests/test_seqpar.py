"""Hop-axis sequence parallelism on a 2x4 virtual CPU mesh: the sharded
render must match the single-device offline driver."""

import numpy as np

import jax

from tests.util import snr_db, tone

from bauklank.engine import StretchConfig, StretchParams, stretch_offline
from bauklank.engine.params import StretchParams as SP
from bauklank.parallel.seqpar import stream_seq_mesh, stretch_offline_sharded

SR = 44100.0


def test_hop_sharded_matches_single_device():
    assert jax.device_count() >= 8
    cfg = StretchConfig(channels=2, block=512, interval=128, formants=True)
    mesh = stream_seq_mesh(2, 4)

    rng = np.random.default_rng(0)
    s = 4
    audio = (rng.standard_normal((s, 2, 40000)) * 0.2).astype(np.float32)
    audio[:, :] += tone(440.0, 40000, SR) * 0.2
    rates = np.asarray([0.5, 1.0, 1.3, 2.0])
    semis = np.asarray([0.0, 5.0, -7.0, 12.0])
    params = SP.stack(
        [SP.make(rate=r, semitones=m, sample_rate=SR) for r, m in zip(rates, semis)]
    )
    n_out = 16 * 1024

    got = np.asarray(
        stretch_offline_sharded(audio, rates, cfg, params, n_out, mesh)
    )
    assert got.shape == (s, 2, n_out)

    for i in range(s):
        p = jax.tree.map(lambda x: x[i], params)
        want = stretch_offline(audio[i], float(rates[i]), cfg, params=p, n_out=n_out)
        s_db = snr_db(want[:, cfg.block :], got[i][:, cfg.block :])
        assert s_db > 45.0, (i, s_db)


def test_hop_sharded_matches_with_transient_resets():
    """The cross-device prefix must compose correctly through per-band
    resets (the 'last reset wins' semigroup)."""
    assert jax.device_count() >= 8
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False,
                        transient_reset_db=6.0)
    mesh = stream_seq_mesh(2, 4)
    rng = np.random.default_rng(1)
    s = 2
    # bursty material so resets actually fire
    audio = np.zeros((s, 1, 30000), np.float32)
    audio[:, 0] += (rng.standard_normal(30000) * 0.05).astype(np.float32)
    for k in range(6):
        p = 2000 + 4500 * k
        audio[:, 0, p : p + 800] += tone(300.0 + 100 * k, 800, SR) * 0.8
    rates = np.asarray([0.6, 1.4])
    params = SP.stack([SP.make(rate=r, semitones=m, sample_rate=SR)
                       for r, m in zip(rates, [4.0, -6.0])])
    n_out = 8 * 1024
    got = np.asarray(stretch_offline_sharded(audio, rates, cfg, params, n_out, mesh))
    for i in range(s):
        p = jax.tree.map(lambda x: x[i], params)
        want = stretch_offline(audio[i], float(rates[i]), cfg, params=p, n_out=n_out)
        s_db = snr_db(want[:, cfg.block :], got[i][:, cfg.block :])
        assert s_db > 45.0, (i, s_db)
