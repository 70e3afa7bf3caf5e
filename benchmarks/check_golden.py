"""Golden SNR of the SERVING fidelity path on the GPU.

The CPU suite pins `batched_fidelity_chunk` >= 40 dB vs real blob renders
(tests/test_golden_wasm.py), but on the CPU the sequential band chain runs
the vmapped lax.scan; on the GPU it runs the Triton kernel
(ops/pallas/bandchain), and XLA's GPU code generation, cuFFT and its
reduction orders round differently.  This script re-runs the golden
cases on the card so the GPU lowering gets the same >= 40 dB gate.
Accumulation-order changes make this mandatory: "bit-identical on CPU"
does NOT imply in-margin on the card (the blob's chain is chaotic).

Usage:
    python benchmarks/check_golden.py [case ...] [--all] [--record]

- default: the three-case smoke set; case names on argv select cases
  (e.g. r0001_st0, the extreme-stretch case with the least margin);
- --all: the FULL committed matrix — every file case incl. the kiosk
  overlap-1 geometry and splitComputation=false, plus every coupled
  (live-input) case;
- --record: merge the per-case results into ``GOLDEN_<device>.json`` at
  the repo root, named after the card (``artifact_name``), with the
  card's name and power limit.  A subset run updates only its own cases;
  an artifact from another device is never overwritten.  bench.py reads
  the floor of the artifact of the device it runs on.

Needs a GPU (exits non-zero without one).  Prints one line per case;
exits non-zero if any case is <= 40 dB.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
FIXTURES = ROOT / "tests" / "golden" / "golden_v1.npz"
FLOOR_DB = 40.0
SMOKE_CASES = ("r025_st0", "r05_stp12", "stereo_r07_stp5_f4_comp")


def artifact_name(device_kind: str) -> str:
    """``GOLDEN_<device kind>.json``, the kind's runs of non-alphanumerics
    folded to one underscore (``NVIDIA H100 80GB HBM3`` ->
    ``GOLDEN_NVIDIA_H100_80GB_HBM3.json``)."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", device_kind).strip("_")
    if not slug:
        raise ValueError(f"empty device kind {device_kind!r}")
    return f"GOLDEN_{slug}.json"


def artifact_path(device_kind: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    return root / artifact_name(device_kind)


def merge_record(path: pathlib.Path, device_kind: str, card: str,
                 results: dict[str, float]) -> dict:
    """The artifact after recording ``results``: cases already in the file
    and not re-run are kept, re-run cases are replaced, and the floor and
    failure list are recomputed over the union.  Refuses a file recorded
    on another device kind."""
    old = json.loads(path.read_text()) if path.exists() else {}
    if old and old.get("device_kind") != device_kind:
        raise ValueError(
            f"{path.name} holds {old.get('device_kind')!r}, not {device_kind!r}")
    cases = {**old.get("cases", {}), **results}
    return {
        "device_kind": device_kind,
        "card": card,
        "min_db": min(cases.values()),
        "n_cases": len(cases),
        "cases": dict(sorted(cases.items())),
        "failed": sorted(n for n, v in cases.items() if v <= FLOOR_DB),
    }


def golden_floor(device_kind: str, root: pathlib.Path = ROOT):
    """The recorded floor (dB) for this device kind, or None."""
    path = artifact_path(device_kind, root)
    if not path.exists():
        return None
    return json.loads(path.read_text()).get("min_db")


def run_file_case(golden, name, rate, semitones, channels, extras):
    import jax
    import jax.numpy as jnp

    from golden_wasm import material

    from bauklank.engine.fidelity import (
        batched_fidelity_chunk, hop_frame_ends,
    )
    from bauklank.engine.spectral import SpectralConfig, init_spectral_state

    sr = material.SR
    ex = material.renderer_extras(extras)
    kw_geom = material.case_render_kwargs(extras)
    block = round(kw_geom["block_ms"] / 1000 * sr)
    interval = round(kw_geom["interval_ms"] / 1000 * sr)
    split = bool(ex.get("split_computation", True))
    use_formants = bool(
        ex.get("formant_semitones") or ex.get("formant_compensation"))
    cfg = SpectralConfig(channels=channels, block=block,
                         interval=interval, formants=use_formants,
                         split=split)
    n_out = int(material.SECONDS * sr)
    hop_chunk = 8
    n_hops = -(-n_out // interval)
    n_hops = -(-n_hops // hop_chunk) * hop_chunk
    ends = hop_frame_ends(cfg, n_hops, rate, sr, split=split)

    key = name + "__seed"
    seed = int(golden[key]) if key in golden.files else 1
    one = lambda x: jnp.broadcast_to(
        jnp.asarray(x), (1,) + jnp.asarray(x).shape)

    @jax.jit
    def init():
        return jax.tree.map(one, (
            init_spectral_state(cfg, seed=seed),
            jnp.zeros((channels, block + interval), jnp.float32),
        ))

    state = init()
    x = material.case_input(rate, channels)
    audios = jnp.asarray(x)[None]
    mult = float(np.exp2(semitones / 12.0))
    # blob seek law: tf saturates at `interval` (rate < 1/interval)
    tf = jnp.asarray([min(1.0 / rate, float(interval))], jnp.float32)
    mult_a = jnp.asarray([mult], jnp.float32)
    limit = jnp.asarray(
        [(material.TONALITY_HZ / sr) / np.sqrt(mult)], jnp.float32)
    active = jnp.ones((1,), jnp.float32)
    kw = {}
    if use_formants:
        kw = dict(
            formant_factor=jnp.asarray(
                [np.exp2(ex.get("formant_semitones", 0.0) / 12.0)],
                jnp.float32),
            formant_compensation=jnp.asarray(
                [1.0 if ex.get("formant_compensation") else 0.0],
                jnp.float32),
            formant_base=jnp.asarray(
                [ex.get("formant_base_hz", 0.0) / sr], jnp.float32),
        )

    step = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
    emitted = []
    for c in range(n_hops // hop_chunk):
        e = jnp.asarray(ends[c * hop_chunk:(c + 1) * hop_chunk])[None]
        state, emit = step(state, audios, e, tf, mult_a, limit,
                           active, **kw)
        emitted.append(np.asarray(emit[0]))
    got = np.concatenate(emitted, axis=-1)[..., :n_out]

    end = int(extras.get("_compare_sec", material.SECONDS) * sr)
    return material.snr_db(golden[name][..., :end], got[..., :end],
                           material.case_skip(extras))


def run_live_case(golden, name, semitones, channels, extras):
    import jax
    import jax.numpy as jnp

    from golden_wasm import material

    from bauklank.engine.fidelity import (
        batched_live_fidelity_chunk, init_batched_live_fidelity_state,
    )
    from bauklank.engine.spectral import SpectralConfig

    sr = material.SR
    ex = material.renderer_extras(extras)
    kw_geom = material.case_render_kwargs(extras)
    block = round(kw_geom["block_ms"] / 1000 * sr)
    interval = round(kw_geom["interval_ms"] / 1000 * sr)
    use_formants = bool(
        ex.get("formant_semitones") or ex.get("formant_compensation"))
    cfg = SpectralConfig(channels=channels, block=block, interval=interval,
                         formants=use_formants,
                         split=bool(ex.get("split_computation", True)))
    n_out = int(material.SECONDS * sr)
    x = material.case_input(1.0, channels)[:, :n_out]
    hop_chunk = 8
    state = init_batched_live_fidelity_state(cfg, hop_chunk, 1)
    mult = float(np.exp2(semitones / 12.0))
    mult_a = jnp.asarray([mult], jnp.float32)
    limit = jnp.asarray(
        [(material.TONALITY_HZ / sr) / np.sqrt(mult)], jnp.float32)
    active = jnp.ones((1,), jnp.float32)
    kw = {}
    if use_formants:
        kw = dict(
            formant_factor=jnp.asarray(
                [np.exp2(ex.get("formant_semitones", 0.0) / 12.0)],
                jnp.float32),
            formant_compensation=jnp.asarray(
                [1.0 if ex.get("formant_compensation") else 0.0],
                jnp.float32),
            formant_base=jnp.asarray(
                [ex.get("formant_base_hz", 0.0) / sr], jnp.float32),
        )
    step = jax.jit(functools.partial(batched_live_fidelity_chunk, cfg))
    n = hop_chunk * interval
    emitted = []
    for c in range(-(-n_out // n)):
        chunk = np.zeros((1, channels, n), np.float32)
        lo, hi = c * n, min((c + 1) * n, n_out)
        chunk[0, :, : hi - lo] = x[:, lo:hi]
        state, emit = step(state, jnp.asarray(chunk), mult_a, limit,
                           active, **kw)
        emitted.append(np.asarray(emit[0]))
    got = np.concatenate(emitted, axis=-1)[..., :n_out]

    end = int(extras.get("_compare_sec", material.SECONDS) * sr)
    return material.snr_db(golden[name][..., :end], got[..., :end],
                           material.case_skip(extras) + interval)


def main():
    from bauklank.utils.compile_cache import (
        card_line, enable_compile_cache, require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    card = card_line()
    from golden_wasm import material

    golden = np.load(FIXTURES)
    print(f"device={device.device_kind} card={card}", file=sys.stderr)

    names = [a for a in sys.argv[1:] if not a.startswith("-")]
    run_all = "--all" in sys.argv
    record = "--record" in sys.argv
    want = set(names) or set(SMOKE_CASES)

    results: dict[str, float] = {}
    failed = []

    def run_one(name, fn, *a):
        # a failed case is recorded (error sentinel) and the run goes on,
        # so the artifact shows exactly which cases broke; the exit code
        # still fails the run
        try:
            snr = fn(golden, name, *a)
        except Exception as e:  # noqa: BLE001 — record and continue
            results[name] = -999.0  # error sentinel (keeps the JSON strict)
            failed.append(name)
            print(f"{name:32s}   ERROR  {type(e).__name__}: {e}",
                  flush=True)
            return
        results[name] = round(snr, 1)
        status = "ok" if snr > FLOOR_DB else "FAIL"
        print(f"{name:32s} {snr:7.1f} dB  {status}  [{card}]", flush=True)
        if snr <= FLOOR_DB:
            failed.append(name)

    for name, rate, semitones, channels, extras in material.CASES:
        if run_all or name in want:
            run_one(name, run_file_case, rate, semitones, channels, extras)
    for name, semitones, channels, extras in material.LIVE_CASES:
        if run_all or name in want:
            run_one(name, run_live_case, semitones, channels, extras)

    if record and results:
        path = artifact_path(device.device_kind)
        art = merge_record(path, device.device_kind, card, results)
        path.write_text(json.dumps(art, indent=1) + "\n")
        print(f"wrote {path} ({art['n_cases']} cases, "
              f"min {art['min_db']} dB)", file=sys.stderr)

    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
