"""Command-line interface: offline rendering, serving, codegen.

Usage (also via ``python -m bauklank``):

    bauklank stretch in.wav out.wav --rate 0.5 --semitones 3
    bauklank serve --engine-count 2 --ws-port 8765 --pool-capacity 2
    bauklank topology-header > time_pitch_mapping.h

``stretch`` is the offline renderer (BASELINE configs 1-3); ``serve`` is
the control-plane server (reference server-multi.py's role).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["main"]


def _cmd_stretch(args) -> int:
    from bauklank.engine import StretchConfig, StretchParams, stretch_offline
    from bauklank.utils.audio import load_audio, save_audio

    planes, sr = load_audio(args.input)
    channels = planes.shape[0]
    block = round(args.block_ms / 1000.0 * sr)
    config = StretchConfig(
        channels=channels,
        block=block,
        interval=max(1, round(block / args.overlap)),
        split_computation=True,
        formants=bool(args.formant_semitones or args.formant_compensation),
    )
    params = StretchParams.make(
        rate=args.rate,
        semitones=args.semitones,
        tonality_hz=args.tonality_hz,
        formant_semitones=args.formant_semitones,
        formant_compensation=1.0 if args.formant_compensation else 0.0,
        formant_base_hz=args.formant_base_hz,
        sample_rate=sr,
    )
    n_out = int(round(planes.shape[1] / max(args.rate, 1e-9)))
    if args.max_seconds:
        n_out = min(n_out, int(args.max_seconds * sr))
    out = stretch_offline(planes, args.rate, config, params=params, n_out=n_out)
    save_audio(args.output, out, sr, as_float=args.float32)
    print(
        f"{args.input} [{channels}ch {planes.shape[1]/sr:.1f}s @{sr}Hz] -> "
        f"{args.output} [{n_out/sr:.1f}s] rate={args.rate} "
        f"semitones={args.semitones}",
        file=sys.stderr,
    )
    return 0


def _cmd_serve(args) -> int:
    from bauklank.serve.server import main as serve_main

    argv = [
        "--engine-count", str(args.engine_count),
        "--slot", args.slot,
        "--ws-host", args.ws_host,
        "--ws-port", str(args.ws_port),
        "--startup-log-level", args.startup_log_level,
        "--run-log-level", args.run_log_level,
        "--serial-log", args.serial_log,
        "--pool-capacity", str(args.pool_capacity),
        "--pool", args.pool,
        "--engine", args.engine,
    ]
    for port in args.serial_exclude:
        argv += ["--serial-exclude", port]
    if args.no_serial_scan:
        argv.append("--no-serial-scan")
    serve_main(argv)
    return 0


def _cmd_topology_header(args) -> int:
    from bauklank.models import DEFAULT_TOPOLOGY

    sys.stdout.write(DEFAULT_TOPOLOGY.c_header())
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bauklank", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    st = sub.add_parser("stretch", help="offline time-stretch/pitch-shift a file")
    st.add_argument("input")
    st.add_argument("output")
    st.add_argument("--rate", type=float, default=1.0,
                    help="input samples per output sample (0.5 = 2x longer)")
    st.add_argument("--semitones", type=float, default=0.0)
    st.add_argument("--tonality-hz", type=float, default=8000.0)
    st.add_argument("--formant-semitones", type=float, default=0.0)
    st.add_argument("--formant-compensation", action="store_true")
    st.add_argument("--formant-base-hz", type=float, default=0.0)
    st.add_argument("--block-ms", type=float, default=120.0)
    st.add_argument("--overlap", type=float, default=4.0)
    st.add_argument("--max-seconds", type=float, default=0.0)
    st.add_argument("--float32", action="store_true", help="write float32 WAV")
    st.set_defaults(fn=_cmd_stretch)

    sv = sub.add_parser("serve", help="run the control-plane server")
    sv.add_argument("--engine-count", type=int, default=1, choices=(1, 2))
    sv.add_argument("--slot", default="A", choices=("A", "B"))
    sv.add_argument("--ws-host", default="0.0.0.0")
    sv.add_argument("--ws-port", type=int, default=8765)
    sv.add_argument("--startup-log-level", default="info")
    sv.add_argument("--run-log-level", default="info")
    sv.add_argument("--serial-log", default="digest", choices=("full", "digest"))
    sv.add_argument("--serial-exclude", action="append", default=[])
    sv.add_argument("--no-serial-scan", action="store_true")
    sv.add_argument("--pool-capacity", type=int, default=0)
    sv.add_argument("--pool", default="stream", choices=("stream", "unified"))
    sv.add_argument("--engine", default="fast", choices=("fast", "fidelity"))
    sv.set_defaults(fn=_cmd_serve)

    th = sub.add_parser("topology-header", help="emit the encoder-firmware C header")
    th.set_defaults(fn=_cmd_topology_header)
    return ap


def main(argv=None) -> int:
    # Honor JAX_PLATFORMS even when jax was imported (and read its config)
    # before this process saw the variable.
    import os

    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms:
        import jax

        try:
            jax.config.update("jax_platforms", platforms)
        except RuntimeError:
            pass  # backend already initialized

    from bauklank.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
