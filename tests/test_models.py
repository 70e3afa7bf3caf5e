"""Voice presets and topology SSOT."""

import pytest

from bauklank.models import (
    DEFAULT_TOPOLOGY,
    DEV_SINGLE,
    KIOSK_ENGINE_A,
    KIOSK_ENGINE_B,
    PRESETS,
    TimePitchTopology,
)


def test_kiosk_presets_match_reference_defaults():
    # reference: app/multi/app.mjs:106-130
    assert KIOSK_ENGINE_A.rate == 0.001
    assert KIOSK_ENGINE_A.tonality_hz == 16000.0
    assert KIOSK_ENGINE_A.formant_base_hz == 200.0
    assert KIOSK_ENGINE_A.volume == 0.10
    assert KIOSK_ENGINE_A.pan == -1.0 and KIOSK_ENGINE_B.pan == +1.0
    assert KIOSK_ENGINE_A.block_ms == 200.0 and KIOSK_ENGINE_A.overlap == 1.0
    cfg = KIOSK_ENGINE_A.config(channels=2, sample_rate=44100.0)
    # 200ms block rounds up to the FFT-fast grid; interval stays overlap-1
    assert cfg.block == 9216 and cfg.interval == 8820
    # reference dev app: app/app.mjs:78-98
    assert DEV_SINGLE.volume == 0.35
    assert DEV_SINGLE.block_ms == 60.0 and DEV_SINGLE.overlap == 1.5
    assert set(PRESETS) == {"kiosk-A", "kiosk-B", "dev-single"}


def test_preset_schedule_obj_keys():
    obj = KIOSK_ENGINE_A.schedule_obj(output=1.0)
    assert obj["rate"] == 0.001 and obj["tonalityHz"] == 16000.0
    from bauklank.schedule import TimeMap

    tm = TimeMap()
    seg = tm.schedule(obj)
    assert seg.rate == 0.001 and seg.tonality_hz == 16000.0


def test_topology_validation():
    t = TimePitchTopology({"c1": {"A": "e1", "B": "e2"}, "c2": {"A": "e3"}})
    assert t.encoder_for("c1", "B") == "e2"
    assert t.channel_encoder_ids("c2") == {"A": "e3"}
    assert list(t.items()) == [("c1", "A", "e1"), ("c1", "B", "e2"), ("c2", "A", "e3")]
    with pytest.raises(ValueError):
        TimePitchTopology({"c1": {"X": "e1"}})
    with pytest.raises(ValueError):
        TimePitchTopology({"c1": {"A": "dup"}, "c2": {"A": "dup"}})
    with pytest.raises(ValueError):
        TimePitchTopology({"c1": {}})


def test_topology_c_header_codegen():
    hdr = DEFAULT_TOPOLOGY.c_header()
    assert "#ifndef TIME_PITCH_MAPPING_H" in hdr
    assert '{"controller-1", "A", "encoder-time"}' in hdr
    assert "TIME_PITCH_TOPOLOGY_LEN 2" in hdr
