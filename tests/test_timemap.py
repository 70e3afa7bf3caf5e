"""Time-map scheduler semantics (SURVEY.md §2.6; reference behavior at
app/SignalsmithStretch.mjs:656-701, 840-889, 617-654)."""

import pytest

from bauklank.schedule import TimeMap


def test_initial_segment_defaults():
    tm = TimeMap()
    seg = tm.current()
    assert seg.active is False
    assert seg.rate == 1.0
    assert seg.tonality_hz == 8000.0
    assert seg.formant_base_hz == 0.0
    assert tm.input_time_at(5.0) == 0.0  # inactive -> input frozen


def test_schedule_extrapolates_input():
    tm = TimeMap()
    tm.schedule({"output": 0.0, "active": True, "rate": 0.5, "input": 10.0})
    seg = tm.schedule({"output": 4.0, "rate": 2.0})
    # missing input extrapolated at the PREVIOUS segment's rate
    assert seg.input == pytest.approx(10.0 + 4.0 * 0.5)
    assert seg.rate == 2.0
    # inherited controls
    assert seg.active is True


def test_inactive_previous_extrapolates_at_zero_rate():
    tm = TimeMap()
    tm.schedule({"output": 0.0, "active": False, "rate": 3.0, "input": 7.0})
    seg = tm.schedule({"output": 2.0, "active": True})
    assert seg.input == pytest.approx(7.0)


def test_schedule_trims_future_segments_and_inherits():
    tm = TimeMap()
    tm.schedule({"output": 0.0, "active": True, "rate": 1.0, "input": 0.0})
    tm.schedule({"output": 10.0, "rate": 0.25, "semitones": 7.0})
    tm.schedule({"output": 20.0, "rate": 0.125})
    # new segment at 5.0 removes the ones at 10 and 20; controls inherit
    # from the last-popped segment (nearest future, output 10)
    seg = tm.schedule({"output": 5.0})
    assert len(tm.segments) == 2
    assert seg.rate == 0.25
    assert seg.semitones == 7.0
    assert seg.input == pytest.approx(5.0)  # extrapolated from rate-1 segment


def test_adjust_previous_refits_rate():
    tm = TimeMap()
    tm.schedule({"output": 0.0, "active": True, "rate": 1.0, "input": 0.0})
    tm.schedule({"output": 4.0, "input": 8.0, "rate": 1.0}, adjust_previous=True)
    prev = tm.segments[-2]
    assert prev.rate == pytest.approx(2.0)  # retro-fit so inputs meet exactly
    assert tm.input_time_at(2.0) == pytest.approx(4.0)


def test_advance_and_input_time():
    tm = TimeMap()
    tm.schedule({"output": 0.0, "active": True, "rate": 1.0, "input": 0.0})
    tm.schedule({"output": 10.0, "rate": 0.5})
    assert tm.input_time_at(5.0) == pytest.approx(5.0)
    assert tm.input_time_at(12.0) == pytest.approx(10.0 + 2.0 * 0.5)
    assert len(tm.segments) == 1  # passed segments dropped


def test_loop_wraparound():
    tm = TimeMap()
    tm.schedule(
        {"output": 0.0, "active": True, "rate": 1.0, "input": 0.0,
         "loopStart": 2.0, "loopEnd": 6.0}
    )
    assert tm.input_time_at(5.0) == pytest.approx(5.0)
    # crossing loopEnd wraps back by the loop length
    assert tm.input_time_at(7.0) == pytest.approx(3.0)
    # anchor was shifted so subsequent reads stay continuous
    assert tm.input_time_at(8.0) == pytest.approx(4.0)


def test_start_stop_sugar():
    tm = TimeMap()
    tm.start(1.0, offset=3.0, duration=4.0, rate=0.5, semitones=-5)
    seg = tm.advance_to(1.0)
    assert seg.active and seg.rate == 0.5 and seg.semitones == -5
    assert tm.input_time_at(3.0) == pytest.approx(3.0 + 2.0 * 0.5)
    seg2 = tm.advance_to(5.5)
    assert seg2.active is False
    tm2 = TimeMap()
    tm2.start(0.0, offset=0.0)
    tm2.stop(2.0)
    assert tm2.advance_to(2.5).active is False


def test_wire_key_aliases():
    tm = TimeMap()
    seg = tm.schedule(
        {"outputTime": 0.0, "active": True, "tone": 5, "tonalityHz": 12000,
         "formantBaseHz": 250, "formantCompensation": True}
    )
    assert seg.semitones == 5.0
    assert seg.tonality_hz == 12000.0
    assert seg.formant_base_hz == 250.0
    assert seg.formant_compensation is True
