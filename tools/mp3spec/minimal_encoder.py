"""Minimal MPEG-1 Layer III encoder (mono, long blocks, CBR).

Two jobs:
- probe frames: inject exact integer spectra (|ix| <= 15, Huffman table
  15, scalefactors 0) so the libmpg123 oracle's PCM reveals the decode
  chain's conventions stage by stage (IMDCT phase, frequency inversion,
  synthesis window) — the method that pinned bauklank/runtime/mp3.py;
- fixture minting: encode a real mono signal via the ISO analysis
  filterbank + MDCT so the repo owns an MPEG-1 test vector with a known
  oracle decode (no encoder exists in the image).

Not a production encoder: no psychoacoustics, no rate loop (global_gain
fixed), no short blocks, no count1 region (everything in big_values).
"""

from __future__ import annotations

import numpy as np

SR = 44100
BITRATE = 128000
FRAME = 144 * BITRATE // SR            # 417 bytes, padding 0
SAMPLES = 1152

# Huffman table 15 codes, derived by walking the extracted LUT chunks
# (mp3_tables.HUFF_TREES[15]) back into (code, length) per (x, y).
_T15_CODES = None


def _t15():
    global _T15_CODES
    if _T15_CODES is None:
        from bauklank.runtime import mp3_tables as T

        tree = T.HUFF_TREES[15]
        codes = {}

        def rec(base, prefix, plen):
            for idx in range(16):
                e = tree[base + idx]
                bits4 = (prefix << 4) | idx
                if e < 0:
                    rec(base + (-e), bits4, plen + 4)
                else:
                    used = e >> 8
                    code = bits4 >> (4 - used)
                    v = e & 0xFF
                    codes.setdefault((v >> 4, v & 15), (code, plen + used))

        rec(0, 0, 0)
        assert len(codes) == 256
        _T15_CODES = codes
    return _T15_CODES


class _BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, value: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bits.append((value >> k) & 1)

    def tell(self):
        return len(self.bits)

    def bytes(self, total_len: int) -> bytes:
        bits = self.bits + [0] * (total_len * 8 - len(self.bits))
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def encode_frame(spectra, global_gain: int = 210) -> bytes:
    """One MPEG-1 Layer III mono frame from two integer spectra.

    ``spectra``: [2][576] ints in [-15, 15] (granule 0, granule 1); the
    requantized value of |ix| = 1 at gain 210 is exactly 1.0.
    """
    codes = _t15()
    w = _BitWriter()
    # header: MPEG1 Layer III, no CRC, 128k, 44.1k, mono
    w.write(0xFFFB9000 | 0xC0, 32)

    # measure each granule's huffman payload first
    payloads = []
    for sp in spectra:
        sp = np.asarray(sp, np.int64)
        assert sp.shape == (576,) and np.abs(sp).max() <= 15
        nz = np.nonzero(sp)[0]
        big = 0 if len(nz) == 0 else int(nz[-1]) // 2 + 1
        # region0 must cover all pairs: region0_count=15 -> boundary
        # long_idx[16] = 162 at 44.1k; big pairs beyond that use table 1 too
        pw = _BitWriter()
        for p in range(big):
            x, y = int(sp[2 * p]), int(sp[2 * p + 1])
            code, ln = codes[(abs(x), abs(y))]
            pw.write(code, ln)
            if x:
                pw.write(1 if x < 0 else 0, 1)
            if y:
                pw.write(1 if y < 0 else 0, 1)
        payloads.append((big, pw))

    # side info (17 bytes): main_data_begin 0, private 0, scfsi 0
    w.write(0, 9)
    w.write(0, 5)
    w.write(0, 4)
    for big, pw in payloads:
        w.write(pw.tell(), 12)        # part2_3_length (no scalefactor bits)
        w.write(big, 9)
        w.write(global_gain, 8)
        w.write(0, 4)                 # scalefac_compress 0 -> slen 0,0
        w.write(0, 1)                 # no window switching
        for _ in range(3):
            w.write(15, 5)            # table 15 everywhere
        w.write(15, 4)                # region0_count
        w.write(4, 3)                 # region1_count
        w.write(0, 1)                 # preflag
        w.write(0, 1)                 # scalefac_scale
        w.write(0, 1)                 # count1table_select
    for _, pw in payloads:
        for b in pw.bits:
            w.bits.append(b)
    assert w.tell() <= FRAME * 8
    return w.bytes(FRAME)


def encode_stream(granule_spectra, global_gain: int = 210) -> bytes:
    """Frames from a [G, 576] integer spectra list (G even)."""
    gs = list(granule_spectra)
    if len(gs) % 2:
        gs.append(np.zeros(576, np.int64))
    out = b""
    for i in range(0, len(gs), 2):
        out += encode_frame(gs[i : i + 2], global_gain)
    return out


# --- real-audio path (fixture minting) ------------------------------------


def analysis_subbands(x: np.ndarray, c_win: np.ndarray) -> np.ndarray:
    """ISO analysis filterbank: x [N] -> subband samples [N//32, 32]."""
    M = np.cos((2 * np.arange(32)[:, None] + 1)
               * (np.arange(64)[None, :] - 16) * np.pi / 64)
    X = np.zeros(512)
    out = []
    for t in range(len(x) // 32):
        X = np.concatenate([x[t * 32 : (t + 1) * 32][::-1], X[:480]])
        out.append(M @ (X * c_win).reshape(8, 64).sum(0))
    return np.array(out)


def mdct_long(sub: np.ndarray) -> np.ndarray:
    """Forward long-block MDCT with sine window: sub [T, 32] ->
    spectra [T//18, 576] (uses the previous granule as left half)."""
    n_gr = sub.shape[0] // 18
    win = np.sin(np.pi / 36 * (np.arange(36) + 0.5))
    k = np.arange(18)[None, :]
    i = np.arange(36)[:, None]
    mat = np.cos(np.pi / 72 * (2 * i + 1 + 18) * (2 * k + 1))  # [36, 18]
    prev = np.zeros((32, 18))
    specs = []
    for g in range(n_gr):
        cur = sub[g * 18 : (g + 1) * 18].T           # [32, 18]
        block = np.concatenate([prev, cur], axis=1)  # [32, 36]
        spec = (block * win) @ mat * (2.0 / 36.0)
        # frequency inversion on odd subbands' odd samples is a decode-side
        # convention; the encoder compensates identically
        specs.append(spec)
        prev = cur
    return specs
