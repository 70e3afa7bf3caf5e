"""Scalar NumPy reference renderer (executable spec for the batched engine)."""

from bauklank.refdsp.renderer import render_offline

__all__ = ["render_offline"]
