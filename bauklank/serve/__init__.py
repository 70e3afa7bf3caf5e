"""Control plane: WebSocket server, stream pool, slot allocation, serial
bridge.  Speaks the reference's wire protocols (SURVEY.md §2.3-2.4)."""

from bauklank.serve.pool import StreamPool, VoiceSlot
from bauklank.serve.livepool import LivePool
from bauklank.serve.slots import SlotAllocator
from bauklank.serve.unified import UnifiedPool

__all__ = [
    "StreamPool",
    "LivePool",
    "UnifiedPool",
    "VoiceSlot",
    "SlotAllocator",
    # imported lazily to avoid pulling websockets unless used:
    # serve.server.ControlServer, serve.client.ControlClient
]
