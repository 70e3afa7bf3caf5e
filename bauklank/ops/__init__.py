"""Pure-function DSP kernels (JAX; Pallas for fused hot paths).

Everything here is shape-static, batched over leading axes, and jit-safe.
The canonical tensor layout is ``[..., streams, hops, block]`` in the time
domain and ``[..., streams, hops, bins]`` in the spectral domain, where
``bins == block // 2`` (modified real DFT, see :mod:`bauklank.ops.mdft`).
"""
