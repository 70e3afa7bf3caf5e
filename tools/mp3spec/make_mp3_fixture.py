"""Mint the committed mp3 fixture: a short joint-stereo MPEG-1 stream
plus its libmpg123 oracle decode.

Output (committed):
- tests/fixtures/tone_jstereo.mp3  — 0.6 s, 44.1 kHz, 128 kbps jstereo
- tests/fixtures/tone_jstereo_oracle.npz — oracle PCM (int16, the
  mixer's own output width) + sample rate

tests/test_mp3.py decodes the mp3 with bauklank.runtime.mp3 and
asserts >= 60 dB against the stored oracle, so the decoder stays gated
even if lame/pygame ever leave the image.

Run: PYTHONPATH=.:tools python tools/mp3spec/make_mp3_fixture.py
"""

from __future__ import annotations

import pathlib

import numpy as np

from mp3spec.lame import lame_encode, oracle_decode, tonal_material

OUT = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
SR = 44100


def main():
    OUT.mkdir(exist_ok=True)
    pcm = tonal_material(SR, int(0.6 * SR), 2, seed=7)
    mp3b = lame_encode(pcm, SR, bitrate=128, mode=1)
    (OUT / "tone_jstereo.mp3").write_bytes(mp3b)
    ora = oracle_decode(mp3b, SR, 2)
    ora16 = np.clip(np.round(ora * 32768.0), -32768, 32767).astype(np.int16)
    np.savez_compressed(OUT / "tone_jstereo_oracle.npz",
                        pcm_int16=ora16, sample_rate=SR)
    print(f"wrote {OUT/'tone_jstereo.mp3'} ({len(mp3b)} bytes) and oracle "
          f"{ora16.shape}")


if __name__ == "__main__":
    main()
