"""Hand-written Pallas kernels (Triton route, GPU) for the hot spectral ops."""
