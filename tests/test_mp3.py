"""Native mp3 decoder (bauklank.runtime.mp3) — C18 ingestion parity.

The reference kiosk's default content is mp3, decoded by the browser's
``decodeAudioData`` (reference app/multi/app.mjs:10-22, 365-395).  Here
the decoder is scored two ways:

- against the COMMITTED oracle fixture (tests/fixtures/tone_jstereo.*,
  minted by tools/mp3spec/make_mp3_fixture.py) — runs everywhere;
- against a LIVE libmpg123 oracle over the full format matrix
  (MPEG-1/2/2.5, mono/stereo/joint-stereo, CBR/VBR), with material
  encoded on the fly by libmp3lame — runs when lame+pygame are present
  (they are in this image).

Every decode also runs with ``check_bits=True``: each granule's
scalefactor+Huffman read must land exactly on part2_3_length, a
desync-sensitive structural check of the tables and region logic.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

from bauklank.runtime.mp3 import decode_mp3

sys.path.insert(0, "tools")

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _aligned_snr(ref: np.ndarray, test: np.ndarray, search: int = 4000,
                 trim: int = 2000) -> float:
    """Best integer-lag SNR (dB) of ``test`` against ``ref`` [ch, n]."""
    n = min(ref.shape[1], test.shape[1])
    a = ref[0, :n].astype(np.float64)
    b = test[0, :n].astype(np.float64)
    xc = np.fft.irfft(np.fft.rfft(a, 2 * n) * np.conj(np.fft.rfft(b, 2 * n)))
    lag = int(np.argmax(np.abs(xc)))
    if lag > n:
        lag -= 2 * n
    if abs(lag) > search:
        lag = 0
    if lag >= 0:
        ra, rb = ref[:, lag:n], test[:, : n - lag]
    else:
        ra, rb = ref[:, : n + lag], test[:, -lag:n]
    m = min(ra.shape[1], rb.shape[1])
    ra = ra[:, trim : m - trim].astype(np.float64)
    rb = rb[:, trim : m - trim].astype(np.float64)
    num = float(np.sum(ra * ra))
    den = float(np.sum((ra - rb) ** 2))
    return 10.0 * np.log10(num / max(den, 1e-30))


def test_committed_fixture_decodes_against_stored_oracle():
    mp3b = (FIXTURES / "tone_jstereo.mp3").read_bytes()
    with np.load(FIXTURES / "tone_jstereo_oracle.npz") as z:
        oracle = z["pcm_int16"].astype(np.float32) / 32768.0
        sr = int(z["sample_rate"])
    pcm, dsr = decode_mp3(mp3b, check_bits=True)
    assert dsr == sr
    assert pcm.shape[0] == 2
    snr = _aligned_snr(oracle, pcm)
    assert snr >= 60.0, f"fixture SNR {snr:.1f} dB < 60 dB"


def _oracle_ready():
    try:
        from mp3spec.lame import lame_available, oracle_available
    except ImportError:
        return False
    return lame_available() and oracle_available()


LIVE_CASES = [
    # (name, sr, channels, lame mode, bitrate, vbr)
    ("mpeg1-jstereo", 44100, 2, 1, 128, False),
    ("mpeg1-mono", 44100, 1, 3, 128, False),
    ("mpeg1-vbr", 44100, 2, 1, 128, True),
    ("mpeg2-stereo-16k", 16000, 2, 1, 64, False),
    ("mpeg2-mono-22k", 22050, 1, 3, 64, False),
    ("mpeg25-mono-8k", 8000, 1, 3, 32, False),
]


@pytest.mark.skipif(not _oracle_ready(), reason="no libmp3lame/pygame oracle")
@pytest.mark.parametrize("name,sr,ch,mode,bitrate,vbr", LIVE_CASES,
                         ids=[c[0] for c in LIVE_CASES])
def test_live_oracle_matrix(name, sr, ch, mode, bitrate, vbr):
    from mp3spec.lame import lame_encode, oracle_decode, tonal_material

    pcm = tonal_material(sr, sr * 2, ch, seed=0)
    mp3b = lame_encode(pcm, sr, bitrate=bitrate, mode=mode, vbr=vbr)
    dec, dsr = decode_mp3(mp3b, check_bits=True)
    assert dsr == sr
    assert dec.shape[0] == ch
    oracle = oracle_decode(mp3b, sr, ch)
    snr = _aligned_snr(oracle, dec)
    assert snr >= 60.0, f"{name}: SNR {snr:.1f} dB < 60 dB vs libmpg123"


def _edge_intensity_stream(mode_ext: int) -> bytes:
    """Joint-stereo intensity frames: mid-band bound (right channel's last
    nonzero at sample 27, inside sfb 6 [24,30) — the bound must round UP
    to 30), is_pos=7 illegal marker in sfb 12, and left-channel content in
    the untransmitted catch-all sfb 21 (samples 418+), which extends sfb
    20's is_pos (ISO 11172-3 2.4.3.4.12)."""
    from mp3spec.edge_frames import encode_frame_js_long

    sp_l = np.zeros(576, np.int64)
    for i, v in ((2, 9), (9, -8), (17, 7), (27, -10),       # below bound
                 (31, 12), (45, -9), (63, 11), (92, -8),    # intensity bands
                 (140, 9), (200, -7), (300, 8), (380, -6),
                 (420, 10), (450, -9)):                     # catch-all sfb 21
        sp_l[i] = v
    sp_r = np.zeros(576, np.int64)
    for i, v in ((2, 7), (9, 6), (17, -5), (27, 8)):        # last nz at 27
        sp_r[i] = v
    sf_l = [0] * 21
    sf_r = [0] * 21
    for b in range(7, 21):              # intensity positions above the bound
        sf_r[b] = 1 + (b % 6)           # 1..6 (legal)
    sf_r[12] = 7                        # illegal marker: MS or L/R fallback
    gr = [[sp_l, sp_r], [sp_l, sp_r]]
    sfs = [[sf_l, sf_r], [sf_l, sf_r]]
    return b"".join(encode_frame_js_long(gr, sfs, mode_ext) for _ in range(30))


def _edge_mixed_stream() -> bytes:
    """Mono mixed-block frames with nonzero long scalefactors in sfbs 6-7
    (samples 24-36) — the region a wrong long/short split at long_idx[6]=24
    would leave unscaled — plus short-region content with subblock gains."""
    from mp3spec.edge_frames import encode_frame_mixed_mono

    sp = np.zeros(576, np.int64)
    for i, v in ((1, 9), (6, -8), (13, 7), (18, -6), (22, 5),
                 (26, 10), (33, -12),                        # sfbs 6-7
                 (37, 6), (41, -5), (49, 4), (61, -5), (91, 6), (121, -4)):
        sp[i] = v
    sf_l8 = [1, 2, 3, 0, 2, 1, 5, 6]
    sf_s = [[0, 0, 0] for _ in range(12)]
    sf_s[3] = [2, 1, 0]
    sf_s[4] = [0, 3, 1]
    sf_s[5] = [1, 0, 2]
    sf_s[6] = [4, 0, 1]
    return b"".join(
        encode_frame_mixed_mono([sp, sp], [sf_l8, sf_l8], [sf_s, sf_s],
                                subblock_gain=(0, 1, 2))
        for _ in range(30)
    )


EDGE_CASES = [
    ("intensity", 2, lambda: _edge_intensity_stream(1)),
    ("ms-intensity", 2, lambda: _edge_intensity_stream(3)),
    ("mixed-blocks", 1, lambda: _edge_mixed_stream()),
]


@pytest.mark.skipif(not _oracle_ready(), reason="no libmpg123 oracle")
@pytest.mark.parametrize("name,ch,mint", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_edge_frames_against_oracle(name, ch, mint):
    """Decoder paths no encoder emits (LAME produces neither intensity
    stereo nor mixed blocks): hand-crafted conforming frames
    (tools/mp3spec/edge_frames.py) scored against libmpg123."""
    from mp3spec.lame import oracle_decode

    mp3b = mint()
    dec, dsr = decode_mp3(mp3b, check_bits=True)
    assert dsr == 44100
    assert dec.shape[0] == ch
    oracle = oracle_decode(mp3b, 44100, ch)
    snr = _aligned_snr(oracle, dec)
    assert snr >= 60.0, f"{name}: SNR {snr:.1f} dB < 60 dB vs libmpg123"


def test_load_audio_decodes_mp3_natively(tmp_path):
    from bauklank.utils.audio import load_audio

    planes, sr = load_audio(FIXTURES / "tone_jstereo.mp3")
    assert sr == 44100 and planes.shape[0] == 2 and planes.dtype == np.float32
    # resample-on-load parity with the WAV path
    planes48, sr48 = load_audio(FIXTURES / "tone_jstereo.mp3", sample_rate=48000)
    assert sr48 == 48000
    assert abs(planes48.shape[1] - planes.shape[1] * 48000 / 44100) < 2


def test_garbage_raises():
    with pytest.raises(ValueError):
        decode_mp3(b"\x00" * 4096)
