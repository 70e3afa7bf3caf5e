"""Host-side scheduling: the per-voice time map."""

from bauklank.schedule.timemap import Segment, TimeMap

__all__ = ["Segment", "TimeMap"]
