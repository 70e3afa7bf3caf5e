"""Live-input (coupled) mode: identity latency, pitch-on-live, node FIFO."""

import numpy as np
import pytest

from tests.util import dominant_freq, snr_db, tone

import jax.numpy as jnp

from bauklank.engine.config import StretchConfig
from bauklank.engine.live import init_live_state, process_live
from bauklank.engine.params import StretchParams
from bauklank.node import StretchNode

SR = 44100.0
CFG = StretchConfig(channels=1, block=1024, interval=256, formants=False)


def test_live_identity_is_delayed_copy():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 0.3).astype(np.float32)
    st = init_live_state(CFG, 1)
    params = StretchParams.make(rate=1.0)
    outs = []
    i = CFG.interval
    for k in range(x.shape[0] // i):
        st, o = process_live(CFG, st, jnp.asarray(x[None, k * i : (k + 1) * i]), params)
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)[0]
    delay = CFG.block - CFG.interval
    n = y.shape[0] - 2 * CFG.block
    s = snr_db(x[CFG.block : CFG.block + n], y[CFG.block + delay : CFG.block + delay + n])
    assert s > 50, s


def test_live_pitch_shift():
    x = tone(440.0, 30000, SR)
    st = init_live_state(CFG, 1)
    params = StretchParams.make(rate=1.0, semitones=12, tonality_hz=8000.0, sample_rate=SR)
    outs = []
    i = CFG.interval
    for k in range(x.shape[0] // i):
        st, o = process_live(CFG, st, jnp.asarray(x[None, k * i : (k + 1) * i]), params)
        outs.append(np.asarray(o))
    y = np.concatenate(outs, axis=1)[0]
    seg = y[3 * CFG.block : 3 * CFG.block + 8192]
    assert abs(dominant_freq(seg, SR) - 880.0) < 6.0


def test_node_live_process_arbitrary_chunks():
    node = StretchNode(sample_rate=SR, channels=1, config=CFG)
    node.schedule({"output": 0.0, "active": True, "semitones": 0})
    x = tone(550.0, 16384, SR)
    outs = []
    pos = 0
    for size in (100, 333, 1024, 4096, 7000, 3331):
        out = node.process(x[pos : pos + size])
        assert out.shape == (1, size)
        outs.append(out)
        pos += size
    y = np.concatenate(outs, axis=1)[0]
    seg = y[CFG.block * 3 :]
    assert abs(dominant_freq(seg, SR) - 550.0) < 6.0
