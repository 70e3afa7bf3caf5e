"""Extract the ISO 11172-3 / 13818-3 Layer III constant tables from the
system's libmpg123 binary into a generated Python module.

The MPEG Layer III decode constants — scalefactor band boundaries
(ISO 11172-3 Table B.8 / 13818-3), the 34 Huffman code trees (Table B.7),
and the synthesis-window prototype (Table B.3) — are public spec data, but
they are far too large to transcribe by hand without error.  This tool
reads them out of the sandbox's own mpg123 build (the exact bit patterns
every conforming decoder shares) instead of trusting human recall:

- loads libmpg123 with ctypes and scans its mapped read-only segments
  (relocations already applied, so embedded pointers are absolute);
- finds `bandInfo[9]` by the 44.1 kHz long-block boundary signature;
- finds `intwinbase[257]` (the half synthesis window x 65536) by its
  leading run;
- finds `ht[32]` (struct {u32 linbits; const short *tree}) by the known
  linbits sequence, plus `htc[2]` directly after, and walks each
  serialized Huffman tree (entry < 0: bit1 jumps forward by -entry,
  bit0 falls through; entry >= 0: leaf) to recover its extent;
- writes bauklank/runtime/mp3_tables.py.

The output module is committed; this tool only needs re-running if the
tables are ever suspected corrupt.  Run: python tools/mp3spec/extract_mpg123_tables.py
"""

from __future__ import annotations

import ctypes
import struct
import sys

LIB = "/opt/venv/lib/python3.12/site-packages/pygame.libs/libmpg123-fad61782.so.0.47.0"
OUT = "bauklank/runtime/mp3_tables.py"

LINBITS = [0] * 16 + [1, 2, 3, 4, 6, 8, 10, 13] + [4, 5, 6, 7, 8, 9, 11, 13]


def load_regions():
    ctypes.CDLL(LIB)
    regions = []
    for line in open("/proc/self/maps"):
        if "libmpg123" in line:
            rng, perms = line.split()[0], line.split()[1]
            a, b = (int(x, 16) for x in rng.split("-"))
            if "r" in perms:
                regions.append((a, b, ctypes.string_at(a, b - a)))
    return regions


def find(regions, key):
    hits = []
    for a, b, d in regions:
        i = d.find(key)
        while i >= 0:
            hits.append(a + i)
            i = d.find(key, i + 1)
    return hits


def read(regions, addr, n):
    for a, b, d in regions:
        if a <= addr and addr + n <= b:
            return d[addr - a : addr - a + n]
    raise ValueError(f"address {addr:#x} not mapped read-only")


def walk_tree(regions, addr):
    """DFS the mpg123 4-bit-LUT Huffman table; returns (entries, leaves).

    Format (read off the binary, verified against Table B.7 for tables 1
    and 7): 16-entry lookup chunks indexed by the next 4 bits (MSB first).
    Entry >= 0 is a leaf: high byte = bits actually consumed from this
    chunk (1-4), low byte = packed symbol (x<<4|y for big-value tables,
    the 4-bit quad for count1).  Entry < 0 jumps to the sub-chunk at
    entry offset -entry RELATIVE TO THE CURRENT CHUNK'S BASE after
    consuming all 4 bits.  Total array length = highest chunk start + 16.
    """
    leaves = set()
    seen = set()
    extent = 0

    def rec(pos, depth):
        nonlocal extent
        if pos in seen:
            return
        if depth > 6:
            raise RuntimeError("runaway table")
        seen.add(pos)
        extent = max(extent, pos + 16)
        chunk = struct.unpack("<16h", read(regions, addr + 2 * pos, 32))
        for e in chunk:
            if e < 0:
                rec(pos - e, depth + 1)
            else:
                assert 1 <= (e >> 8) <= 4, e
                leaves.add(e & 0xFF)

    rec(0, 0)
    entries = list(struct.unpack(f"<{extent}h", read(regions, addr, 2 * extent)))
    return entries, leaves


def walk_bitwise_tree(regions, addr):
    """DFS the classic mpg123 per-bit tree (count1 tables): entry < 0 is a
    node — bit 0 falls through to the next entry, bit 1 jumps forward by
    -entry from the position after the read; entry >= 0 is a leaf quad."""
    leaves = []
    extent = 0

    def rec(pos, depth):
        nonlocal extent
        if depth > 8:
            raise RuntimeError("runaway tree")
        extent = max(extent, pos + 1)
        (a,) = struct.unpack("<h", read(regions, addr + 2 * pos, 2))
        if a >= 0:
            leaves.append(a)
            return
        rec(pos + 1, depth + 1)
        rec(pos + 1 - a, depth + 1)

    rec(0, 0)
    entries = list(struct.unpack(f"<{extent}h", read(regions, addr, 2 * extent)))
    return entries, leaves


def main():
    regions = load_regions()
    lo = min(a for a, _, _ in regions)
    hi = max(b for _, b, _ in regions)

    # bandInfo[9]: {u16 longIdx[23]; u8 longDiff[22]; u16 shortIdx[14];
    # u8 shortDiff[13]} (110 bytes with padding); shortIdx is stored x3.
    key = struct.pack(
        "<23h", 0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110,
        134, 162, 196, 238, 288, 342, 418, 576,
    )
    (band_addr,) = find(regions, key)
    bands = []
    for e in range(9):
        raw = read(regions, band_addr + 110 * e, 110)
        li = struct.unpack_from("<23h", raw, 0)
        si = struct.unpack_from("<14h", raw, 68)
        assert li[0] == 0 and li[22] == 576 and si[0] == 0 and si[13] == 576, (e, li, si)
        bands.append((list(li), [v // 3 for v in si]))

    # intwinbase[257] (long = i64)
    key = struct.pack("<8q", 0, -1, -1, -1, -1, -1, -1, -2)
    (win_addr,) = [h for h in find(regions, key)]
    win = list(struct.unpack("<257q", read(regions, win_addr, 257 * 8)))
    assert max(win) == 75038 and win[256] == 75038, (max(win), win[256])

    # ht[32] struct array, then htc[2] right after
    ht_addr = None
    for a, b, d in regions:
        for off in range(0, len(d) - 16 * 32, 8):
            ok = True
            for k in range(32):
                lb, _, ptr = struct.unpack_from("<IIQ", d, off + 16 * k)
                if lb != LINBITS[k] or not (lo <= ptr < hi):
                    ok = False
                    break
            if ok:
                ht_addr = a + off
                break
        if ht_addr:
            break
    assert ht_addr is not None, "ht[] not found"

    trees, count1_trees = [], []
    for k in range(32):
        lb, _, ptr = struct.unpack("<IIQ", read(regions, ht_addr + 16 * k, 16))
        if k in (0, 4, 14):  # tables 0/4/14: unused, point at the zero stub
            trees.append([])
            continue
        entries, leaves = walk_tree(regions, ptr)
        trees.append(entries)
        xy = {(v >> 4, v & 15) for v in leaves}
        dim = max(max(x for x, _ in xy), max(y for _, y in xy)) + 1
        assert len(xy) == dim * dim, (k, dim, len(xy))

    # htc[2] sits directly BEFORE ht[] (classic per-bit tree format)
    for j in range(2):
        lb, _, ptr = struct.unpack("<IIQ", read(regions, ht_addr - 32 + 16 * j, 16))
        assert lb == 0 and lo <= ptr < hi, (j, lb, hex(ptr))
        entries, leaves = walk_bitwise_tree(regions, ptr)
        assert sorted(leaves) == list(range(16)), (j, sorted(leaves))
        count1_trees.append(entries)

    with open(OUT, "w") as f:
        f.write(
            '"""MPEG Layer III decode constants (GENERATED — do not edit).\n\n'
            "ISO 11172-3 / 13818-3 public spec tables, extracted from the\n"
            "sandbox's libmpg123 by tools/mp3spec/extract_mpg123_tables.py\n"
            "(see that tool's docstring for why extraction beats manual\n"
            "transcription).  Contents: scalefactor band boundaries for all\n"
            "9 sample rates (Table B.8); the 32 big-value Huffman tables\n"
            "(Table B.7) as 4-bit LUT chunks — entry>=0: leaf, high byte =\n"
            "bits consumed (1-4), low byte = x<<4|y; entry<0: consume 4\n"
            "bits and jump to chunk at (current chunk base - entry); the 2\n"
            "count1 tables as per-bit trees — entry<0: node, bit 0 falls\n"
            "through, bit 1 jumps forward -entry; entry>=0: leaf quad;\n"
            "linbits; and the synthesis window prototype x65536 (Table B.3).\n"
            '"""\n\n'
        )
        f.write("# sample-rate order: 44100,48000,32000,22050,24000,16000,11025,12000,8000\n")
        f.write(f"SFB_LONG = {[b[0] for b in bands]!r}\n\n")
        f.write(f"SFB_SHORT = {[b[1] for b in bands]!r}\n\n")
        f.write(f"LINBITS = {LINBITS!r}\n\n")
        f.write(f"HUFF_TREES = {trees!r}\n\n")
        f.write(f"COUNT1_TREES = {count1_trees!r}\n\n")
        f.write(f"INTWINBASE = {win!r}\n")
    print(f"wrote {OUT}: 9 band tables, {len(trees)} big-value trees, "
          f"{len(count1_trees)} count1 trees, {len(win)}-entry window",
          file=sys.stderr)


if __name__ == "__main__":
    main()
