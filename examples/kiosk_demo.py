"""End-to-end installation simulation: the whole kiosk, headless.

Recreates the reference deployment's data flow (SURVEY.md §1) in one
process: two voices (engine slots A/B) with the deployed kiosk presets, a
batched StreamPool with the on-device mixing graph, the WebSocket control
plane, and a FakeController "hardware encoder" turning the rate/tone knobs
mid-performance.  Renders the master mix to a WAV file.

    JAX_PLATFORMS=cpu python examples/kiosk_demo.py out.wav --seconds 8
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np


def main(argv=None) -> int:
    import os

    if os.environ.get("JAX_PLATFORMS"):
        import jax

        try:
            jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
        except RuntimeError:
            pass

    from bauklank.models import KIOSK_ENGINE_A, KIOSK_ENGINE_B
    from bauklank.runtime import wav_write
    from bauklank.serve.pool import StreamPool
    from bauklank.serve.serial import FakeController
    from bauklank.serve.server import ControlServer

    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--sr", type=float, default=44100.0)
    ap.add_argument("--ws-port", type=int, default=0, help="0 = pick a free port")
    args = ap.parse_args(argv)
    sr = args.sr

    # content: a chord + texture, 10 s (the reference ships an mp3; we synth)
    n = int(10 * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(0)
    track = sum(
        a * np.sin(2 * np.pi * f * t + p)
        for f, a, p in [(110, 0.3, 0.1), (220, 0.2, 1.0), (277.2, 0.15, 2.0), (440, 0.1, 0.4)]
    ) + 0.03 * rng.standard_normal(n)
    track = track.astype(np.float32)

    # pool with the two kiosk voices (A panned left, B right), kiosk config
    pool = StreamPool(
        capacity=2, sample_rate=sr, config=KIOSK_ENGINE_A.config(2, sr),
        max_track_sec=10.0, names=["A", "B"], hops_per_step=1,
    )
    for preset, slot in ((KIOSK_ENGINE_A, "A"), (KIOSK_ENGINE_B, "B")):
        pool.load_track(slot, [track, track])
        pool.slots[pool._by_name[slot]].volume = preset.volume
        pool.slots[pool._by_name[slot]].pan = preset.pan
        pool.schedule(slot, preset.schedule_obj(output=0.0))
        # the default 0.001 rate is glacial; give B some motion for the demo
    pool.apply_set("B", "rate", 0.02, lookahead=0.0)

    async def run() -> np.ndarray:
        import socket

        port = args.ws_port
        if port == 0:
            s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port)
        controller = FakeController("demo-encoder")
        server.add_transport(controller)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.3)

        import websockets

        chunks = []
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            for _ in range(3):
                json.loads(await ws.recv())  # beacons
            total = int(args.seconds * sr)
            rendered = 0
            knob = 0
            while rendered < total:
                master, _ = pool.step(fetch=True)
                chunks.append(np.asarray(master))
                rendered += chunks[-1].shape[1]
                # every ~second the "visitor" turns a knob
                if rendered // int(sr) > knob:
                    knob += 1
                    controller.turn("A", "rate", 0.001 * (1 + knob))
                    controller.turn("B", "tone", -knob)
                    await asyncio.sleep(0.05)  # let the scan loop pump
            # one last control confirmation through the wire
            msg = json.loads(await asyncio.wait_for(ws.recv(), 2))
            print(f"last broadcast: {msg}", file=sys.stderr)
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        return np.concatenate(chunks, axis=1)[:, :total]

    master = asyncio.run(run())
    wav_write(args.output, master, int(sr))
    rms = float(np.sqrt((master**2).mean()))
    print(f"wrote {args.output}: {master.shape[1]/sr:.1f}s stereo, rms {rms:.4f}", file=sys.stderr)
    print(f"A rate now: {pool.slots[0].timemap.segments[-1].rate}", file=sys.stderr)
    print(f"B semitones now: {pool.slots[1].timemap.segments[-1].semitones}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
