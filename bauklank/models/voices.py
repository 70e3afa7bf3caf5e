"""Voice presets: the deployed kiosk configurations as data.

Captures the reference app's per-engine defaults (reference:
app/multi/app.mjs:106-130 — "big win in cpu" comment at :128 for the
blockMs=200/overlap=1.0 choice; single-app dev defaults at
app/app.mjs:78-98) so a user of the reference finds the same named
operating points here.
"""

from __future__ import annotations

import dataclasses

from bauklank.engine.config import StretchConfig

__all__ = ["VoicePreset", "KIOSK_ENGINE_A", "KIOSK_ENGINE_B", "DEV_SINGLE", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class VoicePreset:
    """Initial control + config values for one voice."""

    name: str
    # control defaults (applied via schedule)
    rate: float = 0.001          # 1000x slow — the installation's signature
    semitones: float = 0.0
    tonality_hz: float = 16000.0
    formant_semitones: float = 0.0
    formant_compensation: bool = False
    formant_base_hz: float = 200.0
    volume: float = 0.10
    pan: float = 0.0
    # engine config
    block_ms: float = 200.0
    overlap: float = 1.0
    split_computation: bool = True
    # UI rate clamp: the multi app caps at 2 (app/multi/app.mjs:483), the
    # single/dev app at 4 (app/app.mjs:538) — pass to StreamPool(max_rate=)
    max_rate: float = 2.0

    def config(self, channels: int = 2, sample_rate: float = 44100.0) -> StretchConfig:
        block = round(self.block_ms / 1000.0 * sample_rate)
        return StretchConfig(
            channels=channels,
            block=block,
            interval=max(1, round(block / self.overlap)),
            split_computation=self.split_computation,
        )

    def schedule_obj(self, output: float = 0.0, active: bool = True) -> dict:
        return {
            "output": output,
            "active": active,
            "rate": self.rate,
            "semitones": self.semitones,
            "tonalityHz": self.tonality_hz,
            "formantSemitones": self.formant_semitones,
            "formantCompensation": self.formant_compensation,
            "formantBaseHz": self.formant_base_hz,
        }


KIOSK_ENGINE_A = VoicePreset(name="kiosk-A", pan=-1.0)
KIOSK_ENGINE_B = VoicePreset(name="kiosk-B", pan=+1.0)
# dev/mac single-engine app (app/app.mjs:78-98)
DEV_SINGLE = VoicePreset(
    name="dev-single", volume=0.35, pan=0.0, block_ms=60.0, overlap=1.5,
    max_rate=4.0,  # single-app clamp (app/app.mjs:538)
)

PRESETS = {p.name: p for p in (KIOSK_ENGINE_A, KIOSK_ENGINE_B, DEV_SINGLE)}
