"""Read the splitComputation=false placement law off a store trace.

Two hypothesis-testing campaigns (rounds 2-3) failed to lockstep-match the
split-off ring: the head drifts -1/quantum and the stale prefix content was
unexplained (docs/STATUS-r3.md §4-8).  VERDICT r3 item 5 prescribes the
method change used here: the translated blob (wasm2c) now supports store
watchpoints, so instead of guessing frame placement we render a few quanta
at 512/128 split-off with a RAMP input (x[s] = s+1, exact float32
integers) and decode, for every windowed analysis frame the blob writes,
exactly which input sample sits at every window position — dividing each
stored value by the known blob window (machine-precision fit,
engine.spectral.blob_window).  The law is then read, not guessed.

Usage:  python tools/golden_wasm/trace_splitoff.py [--split] [--quanta N]
        [--block B --interval I]

Reference: /root/reference/app/SignalsmithStretch.mjs:787-801 (_configure
ABI, split flag), :934-935 (seek one interval short of the ring with split
off), README-signalsmith.md:1-31 (splitComputation semantics).
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

sys.path.insert(0, "tools")


def f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


def runs_of_consecutive(addrs: list[int]) -> list[tuple[int, int]]:
    """[(base, count)] for maximal runs of 4-byte-stride addresses."""
    out = []
    addrs = sorted(set(addrs))
    i = 0
    while i < len(addrs):
        j = i
        while j + 1 < len(addrs) and addrs[j + 1] == addrs[j] + 4:
            j += 1
        out.append((addrs[i], j - i + 1))
        i = j + 1
    return out


def decode_window_run(values: np.ndarray, window: np.ndarray,
                      n_in: int) -> list[tuple[int, int, int, int]]:
    """Given a stored run values[i] ?= x[s(i)] * window[i] with x[s] = s+1,
    recover s(i) and compress into segments [(i0, i1, s(i0), s(i1))].
    Positions that don't decode (zero padding, non-ramp) become s = -1."""
    n = min(len(values), len(window))
    s = np.full(len(values), -1, np.int64)
    cand = values[:n] / np.where(np.abs(window[:n]) < 1e-12, np.inf, window[:n])
    near = np.abs(cand - np.round(cand)) < 0.25
    ok = near & (np.round(cand) >= 1) & (np.round(cand) <= n_in)
    s[:n][ok] = np.round(cand[ok]).astype(np.int64) - 1
    segs = []
    i = 0
    while i < len(s):
        j = i
        if s[i] < 0:
            while j + 1 < len(s) and s[j + 1] < 0:
                j += 1
            segs.append((i, j, -1, -1))
        else:
            while j + 1 < len(s) and s[j + 1] == s[j] + 1:
                j += 1
            segs.append((i, j, int(s[i]), int(s[j])))
        i = j + 1
    return segs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true", help="splitComputation on")
    ap.add_argument("--quanta", type=int, default=6)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--interval", type=int, default=128)
    ap.add_argument("--rate", type=float, default=1.0)
    args = ap.parse_args()

    from golden_wasm import native
    from bauklank.engine.spectral import blob_window, fft_size_for

    SR = 44100.0
    d = native.WorkletDriver(SR, 1)
    d.wasm._configure(1, args.block, args.interval, 1 if args.split else 0)
    d.wasm._reset()
    d._update_buffers()
    d.input_latency_sec = d.wasm._inputLatency() / SR
    d.output_latency_sec = d.wasm._outputLatency() / SR
    in_lat, out_lat = d.wasm._inputLatency(), d.wasm._outputLatency()
    fft = fft_size_for(args.block)
    print(f"split={'on' if args.split else 'off'} block={args.block} "
          f"interval={args.interval} fft={fft} inputLatency={in_lat} "
          f"outputLatency={out_lat} bufferLength={d.buffer_len}")

    n_in = 8192
    ramp = np.arange(1, n_in + 1, dtype=np.float32)  # x[s] = s+1, exact
    d.add_buffers([ramp])
    d.schedule({"active": True, "input": 0.0, "output": 0.0,
                "rate": args.rate})

    w = blob_window(args.block, args.interval).astype(np.float64)

    sink: list = []
    tag = [None]
    d.wasm.watch_stores(0, 1 << 32, sink, tag)

    QUANTUM = native.QUANTUM
    out = np.zeros((1, QUANTUM), np.float32)
    out_all = []
    for q in range(args.quanta):
        # inline process_quantum so seek/process phases get distinct tags
        n = QUANTUM
        output_time = d.current_time + d.output_latency_sec
        seg = d.time_map[0]
        wv = d.wasm
        tag[0] = (q, "ctl")
        wv._setTransposeSemitones(seg["semitones"], seg["tonalityHz"] / SR)
        wv._setFormantSemitones(seg["formantSemitones"],
                                1 if seg["formantCompensation"] else 0)
        wv._setFormantBase(seg["formantBaseHz"] / SR)
        input_time = seg["input"] + (output_time - seg["output"]) * seg["rate"]
        input_time += d.input_latency_sec
        input_end = round(input_time * SR)
        start = input_end - d.buffer_len
        for c in range(1):
            buf = wv.mem_f32(d.buf_in[c], d.buffer_len)
            buf[:] = 0.0
            lo = max(start, 0)
            hi = min(input_end, n_in)
            if hi > lo:
                buf[lo - start: hi - start] = ramp[lo:hi]
        tag[0] = (q, "seek")
        wv._seek(d.buffer_len, seg["rate"])
        tag[0] = (q, "proc")
        wv._process(0, n)
        d.current_time += n / SR
        out[0, :] = wv.mem_f32(d.buf_out[0], n)
        out_all.append(out.copy())
        print(f"\n-- quantum {q}: inputEnd={input_end} "
              f"(driver window [{start}, {input_end}))")

        # decode the windowed analysis frames written during THIS quantum
        ev = [e for e in sink if e[0] == (q, "seek") or e[0] == (q, "proc")]
        st_addrs = {}
        for t, kind, a, b_, c_ in ev:
            if kind == "st" and b_ == 4:
                st_addrs.setdefault(t[1], []).append((a, c_))
        # bulk copies/fills (ring snapshots etc.), in order
        for t, kind, a, b_, c_ in ev:
            if kind == "cp":
                # decode the copied region as raw ramp integers, reading the
                # SOURCE at post-time (valid for ring->snapshot copies: the
                # ring only changes at seeks, which precede these copies)
                src_v = wv.mem_f32(b_, min(c_ // 4, 1024))
                iv = np.round(src_v.astype(np.float64))
                raw = np.all(np.abs(src_v - iv) < 1e-3) and np.any(iv >= 1)
                desc = ""
                if raw:
                    segs = decode_window_run(
                        np.where(iv >= 1, src_v, np.nan).astype(np.float64),
                        np.ones(len(src_v)), n_in)
                    desc = "  " + "  ".join(
                        f"d[{p}:{r}]=s[{s0}:{s1}]" if s0 >= 0 else f"d[{p}:{r}]=·"
                        for p, r, s0, s1 in segs)
                print(f"  [{t[1]}] COPY  dst={a} src={b_} n={c_ // 4}f{desc}")
            elif kind == "fi":
                print(f"  [{t[1]}] FILL  dst={a} byte={b_} n={c_}B")
        for phase in ("seek", "proc"):
            evs = st_addrs.get(phase, [])
            last_val = {}
            for a, bits in evs:
                last_val[a] = bits
            for base, count in runs_of_consecutive(list(last_val)):
                if count < args.block // 2:
                    continue
                vals = np.array(
                    [f32(last_val[base + 4 * i]) for i in range(count)])
                # raw ramp copy (unwindowed)?
                iv = np.round(vals)
                if np.all(np.abs(vals - iv) < 1e-3) and np.all(
                        (iv >= 0) & (iv <= n_in)):
                    segs = decode_window_run(
                        np.where(iv >= 1, vals, np.nan), np.ones(count), n_in)
                    print(f"  [{phase}] RAW   @{base:7d} n={count:5d}  "
                          + "  ".join(
                            f"i[{a}:{b}]=s[{s0}:{s1}]" if s0 >= 0
                            else f"i[{a}:{b}]=·"
                            for a, b, s0, s1 in segs))
                    continue
                segs = decode_window_run(vals, w, n_in)
                dec = sum(b - a + 1 for a, b, s0, _ in segs if s0 >= 0)
                if dec < count // 4:
                    continue
                print(f"  [{phase}] WIN   @{base:7d} n={count:5d}  "
                      + "  ".join(
                        f"i[{a}:{b}]=s[{s0}:{s1}]" if s0 >= 0
                        else f"i[{a}:{b}]=·"
                        for a, b, s0, s1 in segs))
        sink.clear()

    d.wasm.unwatch_stores()
    # output placement check: where does the ramp surface in the output?
    o = np.concatenate([x[0] for x in out_all])
    nz = np.nonzero(np.abs(o) > 1e-6)[0]
    print(f"\noutput: first nonzero at {nz[0] if len(nz) else '-'} "
          f"of {len(o)}")


if __name__ == "__main__":
    main()
