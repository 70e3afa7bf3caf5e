"""CUDA lowering of the serving graphs, validated without a GPU.

The band chain is chosen per platform when a step is lowered
(``engine.spectral.band_chain_batched`` via ``lax.platform_dependent``), so
``jax.export`` for ``platforms=["cuda"]`` on a CPU host lowers the graph the
card runs, with the Triton band-chain kernel in it.  These tests catch
Pallas/Triton lowering errors (block shapes, unsupported primitives) and
shape bugs of the GPU graph in the CPU suite.  Triton's own compile to PTX
still happens on the card at XLA compile time: ``chip_smoke.py`` phase 6
compiles and checks the kernel there.
"""

import functools

import jax
import jax.numpy as jnp
import pytest

SR = 44100.0
TRITON = "__gpu$xla.gpu.triton"


def export_cuda(fn, *args):
    """Export ``fn`` for CUDA; the Triton custom call is not on
    jax.export's stable list, so that one check is disabled."""
    return jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(TRITON)],
    )(*args)


def has_triton(exp) -> bool:
    return TRITON.encode() in exp.mlir_module_serialized


def _fidelity_args(cfg, s, h, tf=1.0, formants=False):
    from bauklank.engine.fidelity import init_batched_fidelity_state

    states = init_batched_fidelity_state(cfg, s)
    audios = jnp.zeros((s, cfg.channels, int(2 * SR)), jnp.float32)
    ends = jnp.full((s, h), cfg.block + 600, jnp.int32)
    tfa = jnp.full((s,), tf, jnp.float32)
    ones = jnp.ones((s,), jnp.float32)
    limit = jnp.full((s,), 0.18, jnp.float32)
    args = [states, audios, ends, tfa, ones, limit, ones]
    if formants:
        args += [ones * 1.2, ones, jnp.zeros((s,), jnp.float32)]
    return args


@pytest.mark.parametrize(
    "geometry,formants",
    [("preset", False), ("preset", True), ("kiosk", False)],
)
def test_fidelity_step_lowers_for_cuda_with_kernel(geometry, formants):
    """batched_fidelity_chunk at the preset serving geometry (long_step 5,
    with and without the formant path) and at the kiosk point
    (blockMs=200, overlap=1: interval == block, long_step 1, the tf>2
    MINSTD branch compiled in) lowers for CUDA with the Triton chain."""
    from bauklank.engine.fidelity import SpectralConfig, batched_fidelity_chunk

    if geometry == "preset":
        cfg = SpectralConfig(channels=2, block=round(0.12 * SR),
                             interval=round(0.03 * SR), formants=formants)
        tf = 1.0
    else:
        blk = round(0.2 * SR)
        cfg = SpectralConfig(channels=2, block=blk, interval=blk)
        tf = min(1000.0, float(blk))      # rate 0.001, saturated
        assert cfg.long_step == 1
    exp = export_cuda(functools.partial(batched_fidelity_chunk, cfg),
                      *_fidelity_args(cfg, 4, 2, tf=tf, formants=formants))
    assert has_triton(exp)


def test_live_fidelity_step_lowers_for_cuda_with_kernel():
    """The coupled (live-input) pool step lowers for CUDA with the kernel."""
    from bauklank.engine.fidelity import (
        SpectralConfig,
        batched_live_fidelity_chunk,
        init_batched_live_fidelity_state,
    )

    s, h = 4, 2
    cfg = SpectralConfig(
        channels=2, block=round(0.12 * SR), interval=round(0.03 * SR))
    states = init_batched_live_fidelity_state(cfg, h, s)
    chunks = jnp.zeros((s, 2, h * cfg.interval), jnp.float32)
    ones = jnp.ones((s,), jnp.float32)
    limit = jnp.full((s,), 0.18, jnp.float32)
    exp = export_cuda(functools.partial(batched_live_fidelity_chunk, cfg),
                      states, chunks, ones, limit, ones)
    assert has_triton(exp)


def test_cpu_lowering_has_no_kernel():
    """The same step lowered for the CPU takes the lax.scan chain."""
    from bauklank.engine.fidelity import SpectralConfig, batched_fidelity_chunk

    cfg = SpectralConfig(channels=1, block=512, interval=128)
    args = _fidelity_args(cfg, 2, 2)
    f = jax.jit(functools.partial(batched_fidelity_chunk, cfg))
    text = f.lower(*args).as_text()
    assert TRITON not in text


@pytest.mark.parametrize("fused_mdft", [False, True])
def test_entry_lowers_for_cuda(fused_mdft, monkeypatch):
    """The fast-engine step (``__graft_entry__.entry``) lowers for CUDA,
    also with the BAUKLANK_FUSED_MDFT matmul-MDFT variant; it has no band
    chain, so no Triton call."""
    import __graft_entry__ as g
    from bauklank.engine import core as core_mod

    monkeypatch.setattr(core_mod, "_FUSED_MDFT", fused_mdft)
    fn, args = g.entry()
    exp = export_cuda(fn, *args)
    assert len(exp.mlir_module_serialized) > 0
    assert not has_triton(exp)


@pytest.mark.parametrize(
    "channels,long_step,bands,streams",
    [(2, 5, 3072, 128), (2, 1, 5120, 64), (1, 4, 100, 32)],
)
def test_band_chain_kernel_lowers_for_cuda(channels, long_step, bands,
                                           streams):
    """The kernel alone at the preset and kiosk serving widths and at a
    band count off the unroll (tail loop)."""
    from bauklank.ops.pallas.bandchain import CHAN_PLANES, LEAD_PLANES, band_chain

    lead = jax.ShapeDtypeStruct((LEAD_PLANES, bands, streams), jnp.float32)
    chan = jax.ShapeDtypeStruct((channels, CHAN_PLANES, bands, streams),
                                jnp.float32)
    exp = export_cuda(functools.partial(band_chain, long_step=long_step),
                      lead, chan)
    assert has_triton(exp)
    assert exp.out_avals[0].shape == (channels, 2, bands, streams)
