"""Aux subsystems: metrics, checkpoint/resume (pool continuity)."""

import numpy as np
import pytest

from tests.util import tone

from bauklank.engine.config import StretchConfig
from bauklank.serve.pool import StreamPool
from bauklank.utils.checkpoint import load_pool, load_pytree, save_pool, save_pytree
from bauklank.utils.metrics import RateMeter, StepTimer

SR = 44100.0


def _pool():
    cfg = StretchConfig(channels=2, block=512, interval=128)
    return StreamPool(capacity=2, sample_rate=SR, config=cfg,
                      max_track_sec=2.0, names=["A", "B"])


def test_step_timer_percentiles_and_rtf():
    t = StepTimer(sample_rate=100.0)
    for d, n in [(0.01, 100), (0.02, 100), (0.01, 100)]:
        t.start()
        t.durations.append(d)  # deterministic injection
        t.samples.append(n)
        t.total_steps += 1
        t._t0 = None
    assert t.p50_ms == pytest.approx(10.0)
    assert t.p99_ms == pytest.approx(20.0, rel=0.05)
    assert t.rtf == pytest.approx(300.0 / 0.04 / 100.0)
    snap = t.snapshot()
    assert set(snap) == {"steps", "p50_ms", "p99_ms", "rtf"}


def test_rate_meter():
    m = RateMeter(window_sec=2.0)
    for i in range(10):
        m.pulse(now=100.0 + i * 0.1)
    assert m.rate(now=101.0) == pytest.approx(5.0)
    assert m.rate(now=110.0) == 0.0


def test_pytree_roundtrip(tmp_path):
    import jax.numpy as jnp

    tree = {"a": jnp.arange(5.0), "b": (jnp.ones(3, jnp.complex64) * (1 + 2j),
                                        jnp.asarray([1, 2], jnp.int32))}
    save_pytree(tmp_path / "t.npz", tree)
    import jax

    template = jax.tree.map(jnp.zeros_like, tree)
    back = load_pytree(tmp_path / "t.npz", template)
    np.testing.assert_array_equal(np.asarray(back["a"]), np.arange(5.0))
    np.testing.assert_array_equal(np.asarray(back["b"][0]), np.ones(3) * (1 + 2j))


def test_pool_checkpoint_resume_sample_continuity(tmp_path):
    x = tone(440.0, int(SR), SR)
    pool = _pool()
    pool.load_track("A", [x, x])
    pool.start("A", when=0.0, offset=0.0, rate=0.8)
    pool.apply_set("A", "pan", 0.5, lookahead=0.0)
    for _ in range(30):
        pool.step()
    save_pool(tmp_path / "ck", pool)

    # continue the original
    ref = [np.asarray(pool.step(fetch=True)[0]) for _ in range(10)]

    # restore into a fresh pool and continue from the checkpoint
    pool2 = _pool()
    pool2.load_track("A", [x, x])  # content reloaded, like the reference
    load_pool(tmp_path / "ck", pool2)
    got = [np.asarray(pool2.step(fetch=True)[0]) for _ in range(10)]

    np.testing.assert_allclose(
        np.concatenate(ref, axis=1), np.concatenate(got, axis=1), atol=1e-5
    )
    assert pool2.metrics()["steps"] == 10


def test_fidelity_pool_checkpoint_resume(tmp_path):
    """Checkpoint/resume a FIDELITY pool: the spectral state (including the
    carried MINSTD seed — a uint32 leaf) must round-trip sample-exactly."""
    import numpy as np

    from bauklank.serve.pool import StreamPool
    from bauklank.utils.checkpoint import load_pool, save_pool
    from tests.util import tone

    sr = 8000.0

    def fresh():
        pool = StreamPool(capacity=2, sample_rate=sr, channels=1,
                          max_track_sec=2.0, names=["A", "B"],
                          engine="fidelity", hops_per_step=1)
        pool.load_track("A", [tone(440.0, int(sr), sr)])
        # rate 0.25 -> timeFactor 4 -> the MINSTD path advances the seed
        pool.start("A", when=0.0, offset=0.0, rate=0.25)
        return pool

    pool = fresh()
    for _ in range(4):
        pool.step()
    save_pool(tmp_path / "ck", pool)
    want = [np.asarray(pool.step()[0]) for _ in range(3)]

    pool2 = fresh()
    pool2.load_track("A", [tone(440.0, int(sr), sr)])
    load_pool(tmp_path / "ck", pool2)
    got = [np.asarray(pool2.step()[0]) for _ in range(3)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
