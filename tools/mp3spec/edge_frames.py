"""Hand-crafted MPEG-1 Layer III frames for decoder paths no encoder emits.

LAME produces neither intensity stereo nor mixed blocks, so the live
oracle matrix (tests/test_mp3.py) cannot reach those branches of
``bauklank.runtime.mp3``.  This module writes conforming frames
directly — joint-stereo intensity (mode_ext 1 and 3, with mid-band
bounds, the illegal is_pos marker 7, and content in the catch-all sfb
21) and mixed blocks (block_type 2, mixed_block_flag 1, with nonzero
long scalefactors in sfbs 6-7) — for scoring against the sandbox's
libmpg123 (tools/mp3spec/lame.oracle_decode).

Reference parity: the reference kiosk decodes arbitrary user mp3s via
the browser (reference app/multi/app.mjs:10-22); conforming decode of
the full ISO 11172-3 2.4.3.4.12 stereo law is part of C18.

Frame format: MPEG-1 Layer III, 44.1 kHz, 128 kbps, no CRC, no padding.
All spectra are integers |v| <= 15 coded with Huffman table 15;
scalefac_compress 13 gives slen (3, 3) so every scalefactor (and
intensity position) is a 3-bit field 0..7.
"""

from __future__ import annotations

import numpy as np

from .minimal_encoder import _BitWriter, _t15

SR = 44100
FRAME = 144 * 128000 // SR             # 417 bytes


def _huff_payload(sp: np.ndarray) -> tuple[int, _BitWriter]:
    """Big-values payload for one 576-sample integer spectrum (table 15)."""
    codes = _t15()
    sp = np.asarray(sp, np.int64)
    assert sp.shape == (576,) and np.abs(sp).max() <= 15
    nz = np.nonzero(sp)[0]
    big = 0 if len(nz) == 0 else int(nz[-1]) // 2 + 1
    pw = _BitWriter()
    for p in range(big):
        x, y = int(sp[2 * p]), int(sp[2 * p + 1])
        code, ln = codes[(abs(x), abs(y))]
        pw.write(code, ln)
        if x:
            pw.write(1 if x < 0 else 0, 1)
        if y:
            pw.write(1 if y < 0 else 0, 1)
    return big, pw


def _sf_long_payload(sf_l) -> _BitWriter:
    """MPEG-1 long-block scalefactors at slen (3, 3): sfbs 0-10 then 11-20."""
    sf_l = list(sf_l)
    assert len(sf_l) == 21 and all(0 <= v <= 7 for v in sf_l)
    pw = _BitWriter()
    for v in sf_l:
        pw.write(v, 3)
    return pw


def _sf_mixed_payload(sf_l8, sf_s) -> _BitWriter:
    """MPEG-1 mixed-block scalefactors at slen (3, 3): 8 long sfbs, then
    short sfbs 3-5 and 6-11 (3 windows each)."""
    sf_l8 = list(sf_l8)
    assert len(sf_l8) == 8
    pw = _BitWriter()
    for v in sf_l8:
        pw.write(v, 3)
    for b in range(3, 12):
        for w in range(3):
            pw.write(sf_s[b][w], 3)
    return pw


def encode_frame_js_long(gr_specs, gr_sfl, mode_ext: int,
                         global_gain: int = 180) -> bytes:
    """One joint-stereo long-block frame.

    ``gr_specs``: [2][2][576] ints (granule, channel); ``gr_sfl``:
    [2][2][21] scalefactors 0..7 — for the right channel above the
    intensity bound these ARE the intensity positions (7 = illegal
    marker, ISO 11172-3 2.4.3.4.12).  ``mode_ext``: 1 intensity,
    3 MS+intensity.
    """
    w = _BitWriter()
    w.write(0xFFFB9000 | 0x40 | (mode_ext << 4), 32)
    payloads = []
    for gr in range(2):
        for ch in range(2):
            sf = _sf_long_payload(gr_sfl[gr][ch])
            big, hw = _huff_payload(gr_specs[gr][ch])
            payloads.append((big, sf, hw))
    w.write(0, 9)                       # main_data_begin
    w.write(0, 3)                       # private (stereo)
    w.write(0, 8)                       # scfsi
    for big, sf, hw in payloads:
        w.write(sf.tell() + hw.tell(), 12)
        w.write(big, 9)
        w.write(global_gain, 8)
        w.write(13, 4)                  # scalefac_compress -> slen (3, 3)
        w.write(0, 1)                   # no window switching
        for _ in range(3):
            w.write(15, 5)
        w.write(15, 4)                  # region0_count
        w.write(4, 3)                   # region1_count
        w.write(0, 1)                   # preflag
        w.write(0, 1)                   # scalefac_scale
        w.write(0, 1)                   # count1table_select
    for _, sf, hw in payloads:
        w.bits.extend(sf.bits)
        w.bits.extend(hw.bits)
    assert w.tell() <= FRAME * 8
    return w.bytes(FRAME)


def encode_frame_mixed_mono(gr_specs, gr_sfl8, gr_sfs,
                            global_gain: int = 180,
                            subblock_gain=(0, 0, 0)) -> bytes:
    """One mono mixed-block frame (window_switching, block_type 2,
    mixed_block_flag 1).

    ``gr_specs``: [2][576] ints in GRANULE STORAGE ORDER — samples 0..36
    long (sfbs 0-7), then short sfbs window-major per band;
    ``gr_sfl8``: [2][8] long scalefactors; ``gr_sfs``: [2][12][3] short
    scalefactors (rows 3-11 used).
    """
    w = _BitWriter()
    w.write(0xFFFB9000 | 0xC0, 32)      # mono
    payloads = []
    for gr in range(2):
        sf = _sf_mixed_payload(gr_sfl8[gr], gr_sfs[gr])
        big, hw = _huff_payload(gr_specs[gr])
        payloads.append((big, sf, hw))
    w.write(0, 9)
    w.write(0, 5)                       # private (mono)
    w.write(0, 4)                       # scfsi
    for big, sf, hw in payloads:
        w.write(sf.tell() + hw.tell(), 12)
        w.write(big, 9)
        w.write(global_gain, 8)
        w.write(13, 4)                  # slen (3, 3)
        w.write(1, 1)                   # window switching
        w.write(2, 2)                   # block_type 2
        w.write(1, 1)                   # mixed_block_flag
        w.write(15, 5)                  # table_select[0]
        w.write(15, 5)                  # table_select[1]
        for sg in subblock_gain:
            w.write(sg, 3)
        w.write(0, 1)                   # preflag
        w.write(0, 1)
        w.write(0, 1)
    for _, sf, hw in payloads:
        w.bits.extend(sf.bits)
        w.bits.extend(hw.bits)
    assert w.tell() <= FRAME * 8
    return w.bytes(FRAME)


def stream(frames: list[bytes]) -> bytes:
    return b"".join(frames)
