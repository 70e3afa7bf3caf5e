"""Checkpoint / resume: engine state and schedules as plain files.

The reference persists only UI control values in localStorage (disabled in
the deployed app — SURVEY.md §5 "Checkpoint / resume"; app/app.mjs:35-47,
app/multi/app.mjs:85-97) and loses engine state on reload.  Here the whole
per-stream audio state (rotation accumulators, previous spectra, OLA tails)
is an explicit pytree, so checkpointing is one flatten + one npz — and a
StreamPool restores mid-playback with sample continuity.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_pool",
    "load_pool",
    "save_unified",
    "load_unified",
]


def _flatten(tree) -> dict[str, np.ndarray]:
    import jax

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        flat[key] = np.asarray(leaf)
    return flat


def save_pytree(path: str | pathlib.Path, tree) -> None:
    """Save any pytree of arrays to an .npz (complex leaves stored as-is)."""
    np.savez(path, **_flatten(tree))


def load_pytree(path: str | pathlib.Path, template):
    """Load into the structure of ``template`` (same treedef as saved)."""
    import jax

    data = np.load(path, allow_pickle=False)
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for p, leaf in paths_leaves:
        key = jax.tree_util.keystr(p)
        arr = data[key]
        leaves.append(jax.numpy.asarray(arr, dtype=np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_pool(path: str | pathlib.Path, pool) -> None:
    """Checkpoint a StreamPool: device states + schedules + graph controls.

    Tracks themselves are not stored (the reference also reloads content on
    restart — app/multi/app.mjs:774-792); reload them before resuming.
    UnifiedPool instances dispatch to :func:`save_unified`.
    """
    import dataclasses

    if hasattr(pool, "buckets"):
        return save_unified(path, pool)
    path = pathlib.Path(path)
    save_pytree(path.with_suffix(".state.npz"), pool.states)
    meta = {
        "out_pos": pool.out_pos,
        "capacity": pool.capacity,
        "sample_rate": pool.sample_rate,
        "slots": [
            {
                "name": s.name,
                "volume": s.volume,
                "pan": s.pan,
                "track_len": s.track_len,
                "loaded": s.loaded,
                "segments": [dataclasses.asdict(seg) for seg in s.timemap.segments],
            }
            for s in pool.slots
        ],
    }
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def load_pool(path: str | pathlib.Path, pool) -> None:
    """Restore a checkpoint into a compatibly-configured StreamPool.
    UnifiedPool instances dispatch to :func:`load_unified`."""
    from bauklank.schedule.timemap import Segment

    if hasattr(pool, "buckets"):
        return load_unified(path, pool)
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".meta.json").read_text())
    if meta["capacity"] != pool.capacity:
        raise ValueError(f"capacity mismatch: {meta['capacity']} vs {pool.capacity}")
    pool.states = load_pytree(path.with_suffix(".state.npz"), pool.states)
    pool.out_pos = int(meta["out_pos"])
    for s, m in zip(pool.slots, meta["slots"]):
        s.name = m["name"]
        s.volume = s._prev_volume = float(m["volume"])
        s.pan = s._prev_pan = float(m["pan"])
        s.track_len = int(m["track_len"])
        s.loaded = bool(m["loaded"])
        s.timemap.segments = [Segment(**seg) for seg in m["segments"]]
    pool._by_name = {s.name: i for i, s in enumerate(pool.slots)}


# --------------------------------------------------------------- UnifiedPool
def _bucket_ids(pool) -> list[tuple]:
    """Stable ordering of bucket keys for npz namespacing."""
    return sorted(pool.buckets, key=repr)


def save_unified(path: str | pathlib.Path, pool) -> None:
    """Checkpoint a UnifiedPool: every config bucket's device states, the
    bucket FIFOs (the partial chunks between bucket hop cadence and the
    unified quantum), live-input FIFOs, voice configs and schedules.

    Reference analog: the deployed app's reload-resume — a page reload
    re-fetches content and rebuilds engines (app/multi/app.mjs:774-792);
    here the full mid-playback state survives.  Pipelined fetches are
    drained into the bucket FIFOs first (sample order preserved: the drain
    returns in-flight masters in dispatch order), so the emitted sample
    stream is continuous across save/resume.  Tracks are not stored
    (StreamPool policy); reload them before resuming.
    """
    import dataclasses

    path = pathlib.Path(path)
    arrays: dict[str, np.ndarray] = {}
    buckets_meta = {}
    for bi, key in enumerate(_bucket_ids(pool)):
        b = pool.buckets[key]
        if key[0] == "file" and getattr(pool, "pipeline_fetch", False):
            drained = b.pool.drain()
            if drained:
                b.fifo = np.concatenate([b.fifo, *drained], axis=1)
        for k, leaf in _flatten(b.pool.states).items():
            arrays[f"b{bi}/state{k}"] = leaf
        arrays[f"b{bi}/fifo"] = b.fifo
        bm = {
            "key": list(key),
            "capacity": b.pool.capacity,
            "members": dict(b.members),
            "out_pos": b.pool.out_pos,
        }
        if key[0] == "live":
            for inner, arr in zip(b.pool.names, b.pool._in_fifo):
                arrays[f"b{bi}/infifo/{inner}"] = arr
        buckets_meta[str(bi)] = bm
    meta = {
        "kind": "unified",
        "out_pos": pool.out_pos,
        "sample_rate": pool.sample_rate,
        "channels": pool.channels,
        "engine": pool.engine,
        "quantum": pool.quantum,
        "voices": [
            {
                "name": v.name,
                "mode": v.mode,
                "block_ms": v.block_ms,
                "overlap": v.overlap,
                "split": v.split,
                "volume": v.volume,
                "pan": v.pan,
                "segments": [dataclasses.asdict(s) for s in v.timemap.segments],
                "track_len": (
                    b.pool.slots[b.pool._by_name[v.inner]].track_len
                    if v.mode == "file" and v.bucket_key is not None
                    and (b := pool.buckets[v.bucket_key])
                    else 0
                ),
                "loaded": (
                    pool.buckets[v.bucket_key].pool
                    .slots[pool.buckets[v.bucket_key].pool._by_name[v.inner]].loaded
                    if v.mode == "file" and v.bucket_key is not None
                    else False
                ),
            }
            for v in pool.voices.values()
        ],
        "buckets": buckets_meta,
    }
    np.savez(path.with_suffix(".state.npz"), **arrays)
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def load_unified(path: str | pathlib.Path, pool) -> None:
    """Restore a :func:`save_unified` checkpoint into a fresh UnifiedPool
    constructed with the same (sample_rate, channels, engine, quantum)
    parameters.  Existing voices are removed; saved voices are re-added in
    insertion order (bucket slot assignment is deterministic), then each
    bucket's device states / FIFOs / schedules are restored bit-exactly.
    Reload tracks (``load_track``) after this returns."""
    from bauklank.schedule.timemap import Segment

    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".meta.json").read_text())
    if meta.get("kind") != "unified":
        raise ValueError("not a unified-pool checkpoint")
    for want, have in (
        ("sample_rate", pool.sample_rate),
        ("channels", pool.channels),
        ("engine", pool.engine),
        ("quantum", pool.quantum),
    ):
        if meta[want] != have:
            raise ValueError(f"{want} mismatch: {meta[want]} vs {have}")
    data = np.load(path.with_suffix(".state.npz"), allow_pickle=False)
    for name in list(pool.voices):
        pool.remove_voice(name)
    pool.out_pos = int(meta["out_pos"])
    for vm in meta["voices"]:
        pool.add_voice(
            vm["name"], mode=vm["mode"], block_ms=vm["block_ms"],
            overlap=vm["overlap"], split=vm["split"],
            volume=vm["volume"], pan=vm["pan"],
        )
    ids = _bucket_ids(pool)
    if len(ids) != len(meta["buckets"]):
        raise ValueError("bucket set mismatch after re-adding voices")
    for bi, key in enumerate(ids):
        bm = meta["buckets"][str(bi)]
        if list(key) != bm["key"]:
            raise ValueError(f"bucket key mismatch: {key} vs {bm['key']}")
        b = pool.buckets[key]
        if b.members != bm["members"]:
            raise ValueError(
                f"member mapping diverged: {b.members} vs {bm['members']}"
            )
        if int(bm["capacity"]) < b.pool.capacity:
            # grow() is a no-op when the fresh pool is already larger: the
            # restored state leaves would then carry a smaller leading dim
            # than _audio_host/slots and crash on the next step (ADVICE r3)
            raise ValueError(
                f"bucket {key} capacity mismatch: checkpoint has "
                f"{bm['capacity']}, fresh pool already {b.pool.capacity} "
                f"(construct the pool with bucket_capacity <= the saved one)"
            )
        b.pool.grow(int(bm["capacity"]))
        prefix = f"b{bi}/state"
        import jax

        paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(b.pool.states)
        leaves = []
        for p, leaf in paths_leaves:
            arr = data[prefix + jax.tree_util.keystr(p)]
            leaves.append(jax.numpy.asarray(arr, dtype=np.asarray(leaf).dtype))
        b.pool.states = jax.tree_util.tree_unflatten(treedef, leaves)
        b.pool.out_pos = int(bm["out_pos"])
        b.fifo = data[f"b{bi}/fifo"]
        if key[0] == "live":
            for j, inner in enumerate(b.pool.names):
                k = f"b{bi}/infifo/{inner}"
                if k in data:
                    b.pool._in_fifo[j] = data[k]
    for vm in meta["voices"]:
        v = pool.voices[vm["name"]]
        v.timemap.segments = [Segment(**s) for s in vm["segments"]]
        if v.mode == "file":
            p = pool.buckets[v.bucket_key].pool
            s = p.slots[p._by_name[v.inner]]
            s.volume = s._prev_volume = float(vm["volume"])
            s.pan = s._prev_pan = float(vm["pan"])
            s.track_len = int(vm["track_len"])
            s.loaded = bool(vm["loaded"])
