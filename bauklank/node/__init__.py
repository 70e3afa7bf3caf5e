"""High-level voice API (the reference StretchNode equivalent)."""

from bauklank.node.node import StretchNode

__all__ = ["StretchNode"]
