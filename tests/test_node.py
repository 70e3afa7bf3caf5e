"""StretchNode behavioral tests: playback pull, scheduling, rate changes."""

import numpy as np
import pytest

from tests.util import dominant_freq, tone

from bauklank.engine.config import StretchConfig
from bauklank.node import StretchNode

SR = 44100.0


def _node(**kw):
    cfg = StretchConfig(channels=1, block=1764, interval=441)
    return StretchNode(sample_rate=SR, channels=1, config=cfg, **kw)


def test_node_plays_tone_at_rate():
    node = _node()
    node.add_buffers([tone(440.0, int(4 * SR), SR)])
    node.start(when=0.0, offset=0.0, rate=0.5)
    out = node.process_output(int(1.5 * SR))
    assert out.shape == (1, int(1.5 * SR))
    seg = out[0, 2 * node.block_samples : 2 * node.block_samples + 8192]
    assert abs(dominant_freq(seg, SR) - 440.0) < 3.0
    # playhead advanced at the configured rate
    assert node.input_time == pytest.approx(
        (1.5 + node.output_latency / SR) * 0.5, abs=0.05
    )


def test_node_inactive_outputs_silence():
    node = _node()
    node.add_buffers([tone(440.0, int(SR), SR)])
    out = node.process_output(8192)  # initial segment: inactive
    assert np.max(np.abs(out)) == 0.0


def test_node_stop_silences_later_output():
    node = _node()
    node.add_buffers([tone(330.0, int(4 * SR), SR)])
    node.start(when=0.0, offset=0.0, rate=1.0)
    node.stop(when=0.5)
    out = node.process_output(int(1.5 * SR))
    head = out[0, : int(0.3 * SR)]
    tail = out[0, int(1.0 * SR) :]
    assert np.sqrt(np.mean(head**2)) > 0.05
    assert np.sqrt(np.mean(tail**2)) < 0.02


def test_node_schedule_rate_change_moves_playhead_rate():
    node = _node()
    node.add_buffers([np.random.default_rng(0).standard_normal(int(6 * SR)).astype(np.float32) * 0.2])
    node.start(when=0.0, offset=0.0, rate=1.0)
    node.schedule({"output": 0.5, "rate": 0.1})
    node.process_output(int(2.0 * SR))
    lat = node.output_latency / SR
    want = 0.5 + (2.0 + lat - 0.5) * 0.1
    assert node.input_time == pytest.approx(want, abs=0.05)


def test_node_configure_overlap_and_latency():
    node = _node()
    node.configure(blockMs=100, overlap=2.0, splitComputation=True)
    assert node.block_samples == 4608  # 4410 rounded to the FFT-fast grid
    assert node.interval_samples == 2205
    assert node.latency() == pytest.approx((2304 + 2304 + 2205) / SR)
    node.configure(preset="cheaper")
    assert node.block_samples == 4608  # round(SR*0.1) -> fast grid
    assert node.interval_samples == round(SR * 0.04)


def test_node_configure_overlap_clamped_like_reference():
    # the reference UI clamps overlap to [1, 8] (app/multi/app.mjs:410);
    # overlap < 1 would mean interval > block, where the blob's Kaiser
    # bandwidth law has no real beta (NaN window)
    node = _node()
    node.configure(blockMs=100, overlap=0.75)
    assert node.interval_samples <= node.block_samples
    node.configure(blockMs=100, overlap=100.0)
    assert node.interval_samples == round(4410 / 8.0)
    with pytest.raises(ValueError):
        node.configure(blockMs=100, intervalMs=150)


def test_node_loop_region_wraps_playhead():
    """loopStart/loopEnd wrap the input playhead during playback (reference
    loop wrap in the render loop, app/SignalsmithStretch.mjs:884-889)."""
    node = _node()
    node.add_buffers([tone(440.0, int(3 * SR), SR)])
    node.schedule({"output": 0.0, "active": True, "rate": 1.0, "input": 0.5,
                   "loopStart": 0.5, "loopEnd": 1.0})
    node.process_output(int(2.5 * SR))
    t = node.input_time
    assert 0.45 <= t <= 1.05, t  # stayed inside the loop region
    # and the audio keeps playing (not silence after the wrap)
    out = node.process_output(8192)
    assert np.sqrt((out**2).mean()) > 0.1


def test_node_update_callback_fires():
    node = _node()
    node.add_buffers([tone(220.0, int(2 * SR), SR)])
    node.start(when=0.0, offset=0.0)
    times = []
    node.set_update_interval(0.1, times.append)
    node.process_output(int(0.5 * SR))
    assert len(times) >= 3


def test_rate_schedule_rides_one_dispatch():
    """Boundaries that change only timing (rate) no longer split dispatches:
    a 9-segment rate sweep renders in big hop buckets, and the output
    matches a hop-at-a-time render (chunking invariance across segments)."""
    sr = 8000.0
    x = tone(440.0, int(4 * sr), sr)
    cfg = StretchConfig(channels=1, block=512, interval=128, formants=False)

    def build():
        node = StretchNode(sample_rate=sr, channels=1, config=cfg,
                           hops_per_dispatch=1)
        node.add_buffers([x])
        node.start(when=0.0, offset=0.0, rate=0.5)
        for k in range(9):
            node.schedule({"output": k * 0.25, "rate": 0.5 + 1.5 * k / 8})
        return node

    fast = build()
    calls = []
    orig = fast._render_hops
    fast._render_hops = lambda n: (calls.append(n), orig(n))[1]
    out_fast = fast.process_output(int(2.0 * sr))
    assert max(calls) >= 64, calls  # big buckets despite 8 boundaries

    slow = build()
    n = int(2.0 * sr)
    out_slow = np.concatenate(
        [slow.process_output(128) for _ in range(n // 128)], axis=1)
    np.testing.assert_allclose(out_fast, out_slow, atol=1e-4)
