"""Serial control ingest: controller probe/handshake, liveness, fake devices.

Reproduces the reference's serial plane (reference: server-multi.py —
probe/handshake :534-569, scan loop :888-915, per-line forwarding with value
normalization :722-737/:845, encoder liveness from rate-message recency
:173-181/:594-617).  The transport is abstracted so tests (and machines
without hardware) use :class:`FakeController`, a scriptable in-memory device
speaking the exact wire protocol; real pyserial is used when available.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Iterable

from bauklank.serve import protocol

__all__ = [
    "Transport",
    "FakeController",
    "probe_transport",
    "EncoderLiveness",
    "SerialSession",
    "list_pyserial_ports",
]


class Transport:
    """Byte-line transport interface (duck-typed)."""

    def readline(self, timeout: float | None = None) -> bytes: ...
    def write(self, data: bytes) -> None: ...
    def close(self) -> None: ...


class FakeController(Transport):
    """An in-memory 'bauklank-controller' (reference serial protocol §2.4).

    Answers ``whoareyou`` with a ``hello`` and replays queued/scripted
    ``set`` lines.  Also useful interactively:

        fc = FakeController("enc-01")
        fc.turn("A", "rate", 0.01)
    """

    def __init__(self, device_id: str, fw: str = "fake-1.0", script: Iterable[str] = ()) -> None:
        self.device_id = device_id
        self.fw = fw
        self._out: deque[bytes] = deque()
        for line in script:
            self._out.append(line.encode() if isinstance(line, str) else line)
        self.closed = False

    # device-side helpers
    def turn(self, channel: str, key: str, value) -> None:
        self._out.append(
            (json.dumps({"type": "set", "channel": channel, "key": key, "value": value}) + "\n").encode()
        )

    def send_garbage(self, line: str = "not json at all\n") -> None:
        self._out.append(line.encode())

    # Transport interface (host side)
    def readline(self, timeout: float | None = None) -> bytes:
        if self.closed:
            raise OSError("port closed")
        return self._out.popleft() if self._out else b""

    def write(self, data: bytes) -> None:
        if self.closed:
            raise OSError("port closed")
        msg = protocol.parse_line(data)
        if msg and msg.get("type") == "whoareyou":
            self._out.appendleft(protocol.hello_reply(self.device_id, self.fw).encode())

    def close(self) -> None:
        self.closed = True


def list_pyserial_ports(exclude: Iterable[str] = ()) -> list[str]:
    """Candidate hardware ports (reference: server-multi.py:581-583); empty
    when pyserial isn't installed."""
    try:
        from serial.tools import list_ports  # type: ignore
    except ImportError:
        return []
    ex = set(exclude)
    return [p.device for p in list_ports.comports() if p.device not in ex]


def open_pyserial(port: str, baud: int = 115200, timeout: float = 0.5):
    """Open a hardware port (115200 8N1 newline-JSON, reference
    server-multi.py:82,507-531).  Raises ImportError without pyserial."""
    import serial  # type: ignore

    return serial.Serial(port, baudrate=baud, timeout=timeout)


def probe_transport(t: Transport, attempts: int = 3) -> dict | None:
    """whoareyou -> hello handshake (reference: server-multi.py:534-569).

    Returns the hello payload for a bauklank controller, else None.
    """
    for _ in range(attempts):
        t.write(protocol.hello_probe().encode())
        for _ in range(8):
            line = t.readline()
            if not line:
                break
            msg = protocol.parse_line(line)
            if msg and msg.get("type") == "hello" and msg.get("deviceType") == "bauklank-controller":
                return msg
    return None


class EncoderLiveness:
    """Per-channel encoder online/offline inferred from rate-message recency
    with a monotonic clock (reference: server-multi.py:173-181, 594-617)."""

    def __init__(self, channels: Iterable[str], timeout_sec: float = protocol.ENCODER_OFFLINE_TIMEOUT_SEC):
        self.timeout = timeout_sec
        self.last_rx: dict[str, float | None] = {c: None for c in channels}

    def saw_rate(self, channel: str, now: float | None = None) -> None:
        self.last_rx[channel] = time.monotonic() if now is None else now

    def ages_ms(self, now: float | None = None) -> dict[str, float | None]:
        now = time.monotonic() if now is None else now
        return {
            c: None if t is None else (now - t) * 1000.0 for c, t in self.last_rx.items()
        }

    def online(self, channel: str, now: float | None = None) -> bool:
        t = self.last_rx.get(channel)
        now = time.monotonic() if now is None else now
        return t is not None and (now - t) < self.timeout

    def clear(self) -> None:
        for c in self.last_rx:
            self.last_rx[c] = None


class SerialSession:
    """One attached controller: reads lines, normalizes, forwards.

    The forward callback receives the reference ``set`` message with the
    engine tag added (server-multi.py:857-860).
    """

    def __init__(
        self,
        transport: Transport,
        hello: dict,
        channels: list[str],
        forward: Callable[[dict], None],
        liveness: EncoderLiveness | None = None,
        engine_map: dict[str, str] | None = None,
    ) -> None:
        # engine_map: optional local-channel -> engine-slot routing.  None
        # (deployed reference semantics) forwards channel == engine
        # (server-multi.py:857-858); the multi-controller mode pins every
        # local channel of this controller to its allocated slot
        # (server-multi-for-2-controllers_OLD.py:497).
        self.transport = transport
        self.hello = hello
        self.channels = channels
        self.forward = forward
        self.liveness = liveness or EncoderLiveness(channels)
        self.engine_map = engine_map
        self.counters: dict[str, int] = {}  # per-key digest counters (:774-804)

    def pump(self, max_lines: int = 256) -> int:
        """Drain available lines; returns how many set-messages forwarded.
        Raises OSError on transport death (detach path, :863-885)."""
        n = 0
        for _ in range(max_lines):
            line = self.transport.readline()
            if not line:
                break
            msg = protocol.parse_line(line)
            if not msg or msg.get("type") != "set":
                continue
            ch = msg.get("channel")
            key = msg.get("key")
            if not isinstance(key, str) or not isinstance(ch, str):
                continue
            engine = self.engine_map.get(ch) if self.engine_map is not None else ch
            if engine is None or engine not in self.channels:
                continue
            value = protocol.normalize_set_value(key, msg.get("value"))
            if value is None:
                continue
            if key == "rate":
                self.liveness.saw_rate(engine)
            self.counters[key] = self.counters.get(key, 0) + 1
            self.forward(protocol.set_msg(ch, key, value, engine=engine))
            n += 1
        return n
