"""Sequence (hop-axis) parallelism: one render spread over many chips.

For very long offline renders, the hop axis is sharded over a ``seq`` mesh
axis (in addition to ``stream`` data parallelism).  Three things cross
chips, all via XLA collectives riding ICI:

1. the carried band-rotation prefix product — each device computes its local
   cumulative product (``lax.associative_scan``), then composes the global
   prefix from an ``all_gather`` of per-device totals (rotations are unit
   complex, so the composition is exact);
2. the previous-hop mapped spectrum each device's first factor needs — NOT
   communicated: every device analyzes one extra overlap hop locally
   (analysis is pure function of the replicated input audio);
3. the overlap-add boundary — each device's synthesis tail (one block)
   spills into its right neighbor's first samples, exchanged with
   ``lax.ppermute``.

This is the data-parallel generalization of the reference's sequence handling
(STFT block/overlap machinery, SURVEY.md §2.2 last row): the per-hop scalar
loop becomes a frame tensor, and the frame tensor itself shards over chips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bauklank.engine.config import StretchConfig
from bauklank.engine.core import _center_phase, _window_consts, hop_factors
from bauklank.engine.params import StretchParams
from bauklank.ops import framing, mdft, pitchmap

__all__ = ["stream_seq_mesh", "stretch_offline_sharded"]


def stream_seq_mesh(n_stream: int, n_seq: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert n_stream * n_seq <= len(devices)
    arr = np.asarray(devices[: n_stream * n_seq]).reshape(n_stream, n_seq)
    return Mesh(arr, ("stream", "seq"))


def _sharded_render(config: StretchConfig, mesh: Mesh, n_seq: int):
    block, interval = config.block, config.interval
    _, ws, _ = _window_consts(block, interval, config.window_beta)

    def local(audio, ends_ext, params):
        # audio [S_l, C, T]; ends_ext [S_l, 1, H_l+1]; params leaves [S_l]
        ends = ends_ext[:, 0, :]
        zeros_prev = jnp.zeros(
            (audio.shape[0], config.channels, config.bins), jnp.complex64
        )
        v, cur_m, gain, reset = jax.vmap(
            functools.partial(hop_factors, config)
        )(audio, ends, params, zeros_prev)
        # drop the overlap hop: its v is the reset factor (==1), its cur_m
        # seeded the prev-hop chain inside hop_factors
        v = v[:, 1:]
        cur_m = cur_m[:, :, 1:]
        reset = reset[:, 1:]
        if gain is not None:
            gain = gain[:, :, 1:]

        # local prefix under the reset semigroup (see core.rotation_scan)
        def comb(a, b):
            ra, za = a
            rb, zb = b
            return jnp.logical_or(ra, rb), jnp.where(rb, zb, za * zb)

        vals = jnp.where(reset, jnp.ones_like(v), v)
        flags_l, z_l = jax.lax.associative_scan(comb, (reset, vals), axis=1)

        # cross-device composition: fold the per-device totals in order
        tot = (flags_l[:, -1], z_l[:, -1])  # [S_l, bins] each
        all_f = jax.lax.all_gather(tot[0], "seq")  # [D, S_l, bins]
        all_z = jax.lax.all_gather(tot[1], "seq")
        idx = jax.lax.axis_index("seq")
        pf = jnp.zeros_like(tot[0])
        pz = jnp.ones_like(tot[1])
        for k in range(n_seq):
            take = (k < idx)
            fk = jnp.where(take, all_f[k], False)
            zk = jnp.where(take, all_z[k], 1.0 + 0.0j)
            pf, pz = comb((pf, pz), (fk, zk))
        rot_seq = jnp.where(
            flags_l, z_l, pitchmap.unit(pz)[:, None, :] * z_l
        )

        out_spec = rot_seq[:, None] * cur_m
        if gain is not None:
            out_spec = out_spec * gain
        from bauklank.engine.core import _use_fused_mdft

        if _use_fused_mdft():
            frames = mdft.imdft_fused(
                out_spec, block, window=jnp.asarray(ws), center_phase_conj=True
            )  # [S, C, H, B]
        else:
            out_spec = out_spec * jnp.conj(_center_phase(config.bins))
            frames = mdft.imdft(out_spec, block) * ws
        h_local = frames.shape[2]
        ola = framing.overlap_add(frames, interval, h_local * interval + block)
        emit = ola[..., : h_local * interval]
        tail = ola[..., h_local * interval :]  # [S, C, B]
        recv = jax.lax.ppermute(
            tail, "seq", [(d, d + 1) for d in range(n_seq - 1)]
        )
        emit = emit.at[..., :block].add(recv)
        return emit * params.active[:, None, None]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P("stream", None, None),
                P("stream", "seq", None),
                P("stream"),
            ),
            out_specs=P("stream", None, "seq"),
        )
    )


def stretch_offline_sharded(
    audio: np.ndarray,
    rates: np.ndarray,
    config: StretchConfig,
    params: StretchParams,
    n_out: int,
    mesh: Mesh,
):
    """Render ``n_out`` samples of every stream, hops sharded over ``seq``.

    audio: [S, C, T]; rates: [S]; params: batched [S] pytree.
    Requires hops divisible by the seq axis and local hops * interval >=
    block (so the OLA spill stays within one neighbor).
    """
    i = config.interval
    n_seq = mesh.shape["seq"]
    h_total = -(-n_out // i)
    h_total = -(-h_total // n_seq) * n_seq
    h_local = h_total // n_seq
    assert h_local * i >= config.block, (
        f"need >= {config.block // i + 1} local hops per device for the OLA halo"
    )

    # per-stream, per-device hop windows with one overlap hop in front
    s = audio.shape[0]
    ends = np.zeros((s, n_seq, h_local + 1), np.int64)
    b = config.block
    for si in range(s):
        rate = float(np.asarray(rates)[si])
        g = np.arange(-1, h_total, dtype=np.float64)  # global hop index, -1 = overlap
        centers = (g * i + b / 2.0) * rate
        e = np.round(centers).astype(np.int64) + b // 2
        for d in range(n_seq):
            ends[si, d, 0] = e[d * h_local]          # overlap hop (g = local0 - 1)
            ends[si, d, 1:] = e[d * h_local + 1 : (d + 1) * h_local + 1]
        # device 0 has no previous hop: park its overlap frame fully out of
        # range so the prev-spectrum is zero and hop 0 phase-restarts from
        # the input, exactly like the single-chip engine after reset.
        ends[si, 0, 0] = -10 * b

    render = _sharded_render(config, mesh, n_seq)
    audio_sh = jax.device_put(jnp.asarray(audio, jnp.float32),
                              NamedSharding(mesh, P("stream", None, None)))
    ends_sh = jax.device_put(jnp.asarray(ends, jnp.int32),
                             NamedSharding(mesh, P("stream", "seq", None)))
    params_sh = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("stream"))), params
    )
    out = render(audio_sh, ends_sh, params_sh)
    return out[..., :n_out]
