"""Control-plane tests: protocol shapes, slot allocation, serial handshake,
pool control routing, and a live WebSocket end-to-end session."""

import asyncio
import json
import socket

import numpy as np
import pytest

from tests.util import tone

from bauklank.engine.config import StretchConfig
from bauklank.serve import protocol
from bauklank.serve.pool import StreamPool
from bauklank.serve.serial import EncoderLiveness, FakeController, SerialSession, probe_transport
from bauklank.serve.server import ControlServer
from bauklank.serve.slots import SlotAllocator

SR = 44100.0


# ------------------------------------------------------------------ protocol
def test_protocol_messages_shape():
    v = protocol.server_version_msg()
    assert v["type"] == "serverVersion" and v["version"]
    m = protocol.machine_status_msg()
    assert m["type"] == "machineStatus"
    for k in ("hostname", "user", "platform", "arch", "ip", "ips", "python"):
        assert k in m
    c = protocol.controller_status_msg(
        connected=True, port="/dev/x", device_id="d1", fw="1",
        engines=["A", "B"], encoder_ages_ms={"A": 100.0, "B": None},
    )
    assert c["encoders"]["channels"]["A"]["online"] is True
    assert c["encoders"]["channels"]["B"]["online"] is False
    assert c["encoders"]["timeoutSec"] == 10.0
    s = protocol.set_msg("A", "rate", 0.01)
    assert s == {"type": "set", "channel": "A", "engine": "A", "key": "rate", "value": 0.01}


def test_normalize_set_value():
    assert protocol.normalize_set_value("volume", "42.7") == 43
    assert protocol.normalize_set_value("tone", -3.2) == -3
    assert protocol.normalize_set_value("rate", "0.125") == 0.125
    assert protocol.normalize_set_value("rate", "garbage") is None
    assert protocol.normalize_set_value("other", "x") == "x"


def test_parse_line_tolerates_garbage():
    assert protocol.parse_line(b"hello world\n") is None
    assert protocol.parse_line(b"{broken json\n") is None
    assert protocol.parse_line(b"[1,2]\n") is None
    assert protocol.parse_line(b'{"type":"set"}\n') == {"type": "set"}


# --------------------------------------------------------------------- slots
def test_slot_allocator_pinned_then_first_free():
    a = SlotAllocator(["A", "B"], pinned={"dev2": "B"})
    assert a.assign("dev1") == "A"
    assert a.assign("dev2") == "B"
    assert a.assign("dev3") is None  # full
    assert a.assign("dev1") == "A"   # idempotent
    assert a.release("dev1") == "A"
    assert a.free_slots() == ["A"]
    # pinned conflict: dev4 pinned to occupied B
    a2 = SlotAllocator(["A", "B"], pinned={"dev4": "B", "dev5": "B"})
    assert a2.assign("dev4") == "B"
    assert a2.assign("dev5") is None


# -------------------------------------------------------------------- serial
def test_fake_controller_probe_and_pump():
    fc = FakeController("enc-7", fw="2.0")
    hello = probe_transport(fc)
    assert hello["deviceId"] == "enc-7" and hello["fw"] == "2.0"

    got = []
    sess = SerialSession(fc, hello, ["A", "B"], got.append)
    fc.send_garbage()
    fc.turn("A", "rate", "0.25")
    fc.turn("A", "volume", 17.6)
    fc.turn("C", "rate", 1.0)  # unknown channel dropped
    fc.turn("B", "tone", -5)
    n = sess.pump()
    assert n == 3
    assert got[0] == {"type": "set", "channel": "A", "engine": "A", "key": "rate", "value": 0.25}
    assert got[1]["value"] == 18  # int-normalized volume
    assert got[2] == {"type": "set", "channel": "B", "engine": "B", "key": "tone", "value": -5}
    assert sess.counters == {"rate": 1, "volume": 1, "tone": 1}
    assert sess.liveness.online("A") and not sess.liveness.online("B")


def test_encoder_liveness_timeout():
    lv = EncoderLiveness(["A"], timeout_sec=10.0)
    lv.saw_rate("A", now=100.0)
    assert lv.online("A", now=105.0)
    assert not lv.online("A", now=111.0)
    ages = lv.ages_ms(now=101.0)
    assert ages["A"] == pytest.approx(1000.0)


def test_detached_transport_raises():
    fc = FakeController("enc-9")
    hello = probe_transport(fc)
    sess = SerialSession(fc, hello, ["A"], lambda m: None)
    fc.close()
    with pytest.raises(OSError):
        sess.pump()


# ---------------------------------------------------------------------- pool
def _pool(capacity=2):
    cfg = StretchConfig(channels=2, block=512, interval=128)
    return StreamPool(capacity=capacity, sample_rate=SR, config=cfg,
                      max_track_sec=2.0, names=["A", "B"][:capacity])


def test_pool_apply_set_clamps_and_routes():
    pool = _pool()
    assert pool.apply_set("A", "rate", 99.0)
    seg = pool.slots[0].timemap.segments[-1]
    assert seg.rate == 2.0  # clamped to reference UI max
    assert pool.apply_set("A", "semitones", -100)
    assert pool.slots[0].timemap.segments[-1].semitones == -48.0
    assert pool.apply_set("A", "volumePercent", 250)
    assert pool.slots[0].volume == 1.0
    assert pool.apply_set("A", "pan", -7)
    assert pool.slots[0].pan == -1.0
    assert not pool.apply_set("Z", "rate", 1.0)   # unknown slot
    assert not pool.apply_set("A", "bogus", 1.0)  # unknown key


def test_pool_apply_set_rejects_malformed_values():
    """Unauthenticated WS JSON can carry NaN/Infinity tokens and nulls; one
    NaN rate would poison the time map and crash-loop the render task."""
    pool = _pool()
    before = list(pool.slots[0].timemap.segments)
    assert not pool.apply_set("A", "rate", float("nan"))
    assert not pool.apply_set("A", "rate", float("inf"))
    assert not pool.apply_set("A", "rate", None)       # JS JSON.stringify(NaN) -> null
    assert not pool.apply_set("A", "rate", "fast")
    assert not pool.apply_set("A", "volume", float("nan"))
    assert not pool.apply_set("A", "pan", {"x": 1})
    assert pool.slots[0].timemap.segments == before
    assert pool.slots[0].volume == 0.1 and pool.slots[0].pan == 0.0
    # string numbers still work (serial values arrive as JSON numbers, but
    # be liberal in what float() accepts)
    assert pool.apply_set("A", "rate", "0.5")
    assert pool.slots[0].timemap.segments[-1].rate == 0.5


def test_pool_step_renders_and_mixes():
    pool = _pool()
    x = tone(440.0, int(SR), SR)
    pool.load_track("A", [x, x])
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    pool.apply_set("A", "pan", -1.0, lookahead=0.0)
    pool.slots[0].volume = 0.5
    # B stays silent (inactive, no track)
    outs = []
    for _ in range(40):
        master, streams = pool.step()
        outs.append(np.asarray(master))
    master = np.concatenate(outs, axis=1)
    assert master.shape[0] == 2
    # voice A panned hard left: left channel carries signal, right ~0
    tail = master[:, -2000:]
    assert np.sqrt((tail[0] ** 2).mean()) > 0.01
    assert np.sqrt((tail[1] ** 2).mean()) < 1e-6
    _, streams = pool.step()
    assert np.asarray(streams).shape[0] == 2
    assert np.abs(np.asarray(streams)[1]).max() == 0.0  # voice B silent


def test_pool_input_time_tracks_rate():
    pool = _pool()
    pool.load_track("A", [tone(220.0, int(SR), SR)])
    pool.start("A", when=0.0, offset=0.0, rate=0.5)
    for _ in range(20):
        pool.step()
    t = pool.input_time("A")
    assert t == pytest.approx(pool.output_time * 0.5, abs=0.02)


def test_hardware_scan_path(monkeypatch):
    """The scan loop probes pyserial-discovered ports (faked here) and
    respects the exclude list (reference SERIAL_PORT_EXCLUDE)."""
    from bauklank.serve import serial as ser_mod

    async def scenario():
        opened = []
        devices = {"/dev/ttyUSB0": FakeController("hw-enc"),
                   "/dev/ttyEXCL": FakeController("nope")}

        monkeypatch.setattr(
            ser_mod, "list_pyserial_ports",
            lambda exclude=(): [p for p in devices if p not in set(exclude)],
        )

        def fake_open(port, baud=115200, timeout=0.5):
            opened.append(port)
            return devices[port]

        monkeypatch.setattr(ser_mod, "open_pyserial", fake_open)

        server = ControlServer(engine_slots=["A"], serial_exclude=["/dev/ttyEXCL"])
        task = asyncio.create_task(server.serial_manager_task())
        for _ in range(60):
            if server.session is not None:
                break
            await asyncio.sleep(0.05)
        assert server.session is not None
        assert server.session.hello["deviceId"] == "hw-enc"
        assert "/dev/ttyEXCL" not in opened
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    asyncio.run(scenario())


def test_soak_control_churn():
    """~8s soak: encoder spam + client joins/leaves + garbage + pool stepping
    concurrently; server must stay consistent and keep routing."""
    import random

    import websockets

    async def scenario():
        rng = random.Random(7)
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port)
        fc = FakeController("enc-soak")
        server.add_transport(fc)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)

        received = [0]

        async def client_life():
            try:
                async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                    await ws.send(json.dumps({"type": "hello", "engineSlots": ["A"]}))
                    end = asyncio.get_event_loop().time() + rng.uniform(0.3, 1.5)
                    while asyncio.get_event_loop().time() < end:
                        try:
                            json.loads(await asyncio.wait_for(ws.recv(), 0.5))
                            received[0] += 1
                        except asyncio.TimeoutError:
                            pass
                        if rng.random() < 0.2:
                            await ws.send(json.dumps({
                                "type": "set", "channel": rng.choice(["A", "B"]),
                                "key": rng.choice(["rate", "tone", "volume", "pan"]),
                                "value": rng.uniform(-5, 5),
                            }))
            except Exception:
                pass

        async def churn():
            end = asyncio.get_event_loop().time() + 8.0
            while asyncio.get_event_loop().time() < end:
                fc.turn(rng.choice(["A", "B", "C"]), rng.choice(["rate", "tone", "volume"]),
                        rng.uniform(-10, 10))
                if rng.random() < 0.1:
                    fc.send_garbage()
                if rng.random() < 0.3:
                    pool.step()
                await asyncio.sleep(0.02)

        clients = [asyncio.create_task(client_life()) for _ in range(3)]

        async def respawn():
            end = asyncio.get_event_loop().time() + 8.0
            while asyncio.get_event_loop().time() < end:
                await asyncio.sleep(0.5)
                clients.append(asyncio.create_task(client_life()))

        await asyncio.gather(churn(), respawn())
        await asyncio.gather(*clients, return_exceptions=True)

        assert received[0] > 50, received  # traffic flowed throughout
        # control state stayed sane (clamps respected)
        seg = pool.slots[0].timemap.segments[-1]
        assert 1e-5 <= seg.rate <= 2.0
        assert -48.0 <= seg.semitones <= 48.0
        assert np.isfinite(np.asarray(pool.step()[0])).all()

        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    asyncio.run(scenario())


def test_http_status_surface():
    """Plain HTTP on the WS port: '/' serves the status page, '/status'
    serves JSON, WS upgrades still work (the reference UI's status-bar
    facts, headless)."""
    import urllib.request

    import websockets

    async def scenario():
        port = _free_port()
        server = ControlServer(pool=_pool(), engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.3)
        try:
            def get(path):
                return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5)

            status = await asyncio.to_thread(get, "/status")
            payload = json.loads(status.read())
            assert payload["server"]["type"] == "serverVersion"
            assert payload["controller"]["connected"] is False
            assert payload["pool"] is not None
            # active engine surfaced for operators (VERDICT r3 item 3)
            assert payload["engine"] == "fast"

            page = await asyncio.to_thread(get, "/")
            body = page.read().decode()
            assert "bauklank control plane" in body

            try:
                await asyncio.to_thread(get, "/nope")
                assert False, "expected 404"
            except urllib.error.HTTPError as e:
                assert e.code == 404

            # the websocket upgrade still works on the same port
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                m = json.loads(await asyncio.wait_for(ws.recv(), 3))
                assert m["type"] == "serverVersion"
        finally:
            server.stop()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    asyncio.run(scenario())


def test_task_supervision_restarts_crashed_task():
    async def scenario():
        server = ControlServer(engine_slots=["A"])
        calls = []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("boom")
            server.stop()

        task = asyncio.create_task(server._supervise(flaky, "flaky"))
        for _ in range(100):
            if task.done():
                break
            await asyncio.sleep(0.05)
        assert len(calls) == 3  # crashed twice, restarted, then clean exit
        await task

    asyncio.run(scenario())


def test_controller_status_topology_decoration():
    """The topology SSOT decorates per-channel encoder deviceIds
    (reference: server-multi.py:26-31, 643-649)."""
    from bauklank.models import TimePitchTopology

    async def scenario():
        topo = TimePitchTopology({"enc-top": {"A": "enc-time", "B": "enc-pitch"}})
        server = ControlServer(engine_slots=["A", "B"], topology=topo)
        fc = FakeController("enc-top")
        server.add_transport(fc)
        task = asyncio.create_task(server.serial_manager_task())
        await asyncio.sleep(0.15)
        st = server.controller_status()
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        assert st["connected"] is True
        assert st["encoders"]["channels"]["A"]["deviceId"] == "enc-time"
        assert st["encoders"]["channels"]["B"]["deviceId"] == "enc-pitch"

    asyncio.run(scenario())


def test_serial_digest_logging(caplog):
    """Digest mode logs per-key message-count deltas (reference serial log
    modes, server-multi.py:163-168, 774-804)."""
    import logging
    import time as _time

    async def scenario():
        server = ControlServer(engine_slots=["A"], serial_log="digest")
        fc = FakeController("enc-dig")
        server.add_transport(fc)
        task = asyncio.create_task(server.serial_manager_task())
        await asyncio.sleep(0.1)
        for _ in range(5):
            fc.turn("A", "rate", 0.3)
        fc.turn("A", "volume", 10)
        server._digest_last = _time.monotonic() - 11.0  # force a digest tick
        with caplog.at_level(logging.INFO, logger="bauklank.serve"):
            await asyncio.sleep(0.3)
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        digest_lines = [r.message for r in caplog.records if "serial digest" in r.message]
        assert digest_lines, caplog.records
        assert "rate" in digest_lines[0]

    asyncio.run(scenario())


def test_utils_version_format():
    from bauklank.utils.version import full_version

    v = full_version("/root/repo")
    assert v.startswith("0.1.0")
    assert "+g" in v  # git hash decoration like the reference server


def test_server_survives_malformed_frames():
    """Garbage, wrong-typed, unknown-slot, and unknown-key frames must not
    kill the connection or the server (the reference only logs inbound
    frames; we additionally route valid sets)."""
    import websockets

    async def scenario():
        port = _free_port()
        server = ControlServer(pool=_pool(), engine_slots=["A"],
                               ws_host="127.0.0.1", ws_port=port)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                for _ in range(3):
                    await asyncio.wait_for(ws.recv(), 2)
                for frame in (
                    "not json", "{broken", "[1,2,3]", '{"type": 42}',
                    '{"type":"set"}',
                    '{"type":"set","channel":"Z","key":"rate","value":1}',
                    '{"type":"set","channel":"A","key":7,"value":1}',
                    '{"type":"set","channel":"A","key":"bogus","value":1}',
                ):
                    await ws.send(frame)
                # still alive: a valid set round-trips
                await ws.send(json.dumps({"type": "set", "channel": "A",
                                          "key": "rate", "value": 0.25}))
                while True:
                    m = json.loads(await asyncio.wait_for(ws.recv(), 3))
                    # unknown-but-well-formed keys are forwarded (reference
                    # semantics: the server forwards, receivers ignore)
                    if m.get("type") == "set" and m.get("key") == "rate":
                        assert m["value"] == 0.25
                        break
        finally:
            server.stop()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    asyncio.run(scenario())


def test_control_client_end_to_end_and_reconnect():
    """ControlClient tracks beacons, dispatches sets, and survives a server
    restart (reconnect loop like the reference frontend)."""
    from bauklank.serve.client import ControlClient

    async def scenario():
        port = _free_port()
        pool = _pool()
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port)
        fc = FakeController("enc-cli")
        server.add_transport(fc)
        stask = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)

        sets = []
        client = ControlClient(f"ws://127.0.0.1:{port}", ["A", "B"],
                               on_set=sets.append, reconnect="backoff")
        ctask = asyncio.create_task(client.run())
        for _ in range(50):
            if client.server_version and client.controller_status:
                break
            await asyncio.sleep(0.05)
        assert client.server_version
        assert client.machine_status["type"] == "machineStatus"

        fc.turn("A", "rate", 0.5)
        for _ in range(50):
            if sets:
                break
            await asyncio.sleep(0.05)
        assert sets[0]["key"] == "rate" and sets[0]["value"] == 0.5

        # client-originated control reaches the pool
        await client.send_set("B", "tone", 3)
        for _ in range(50):
            if pool.slots[1].timemap.segments[-1].semitones == 3.0:
                break
            await asyncio.sleep(0.05)
        assert pool.slots[1].timemap.segments[-1].semitones == 3.0

        # kill the server; client must drop to disconnected and keep trying
        server.stop()
        stask.cancel()
        try:
            await stask
        except (asyncio.CancelledError, Exception):
            pass
        for _ in range(100):
            if not client.connected:
                break
            await asyncio.sleep(0.05)
        assert not client.connected

        # bring a fresh server up on the same port: client reconnects
        server2 = ControlServer(pool=pool, engine_slots=["A", "B"],
                                ws_host="127.0.0.1", ws_port=port)
        stask2 = asyncio.create_task(server2.run())
        for _ in range(200):
            if client.connected:
                break
            await asyncio.sleep(0.05)
        assert client.connected

        client.stop()
        server2.stop()
        for task in (ctask, stask2):
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    asyncio.run(scenario())


def test_render_loop_paces_to_realtime():
    """The server's render loop keeps the sink ~render_ahead ahead of the
    wall clock (BASELINE config 4 serving cadence)."""
    from bauklank.runtime import RingBuffer

    async def scenario():
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        ring = RingBuffer(1 << 20)
        got = []

        def sink(master):
            got.append(np.asarray(master))
            ring.push(np.asarray(master)[0])

        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               audio_sink=sink, render_ahead_sec=0.2)
        task = asyncio.create_task(server.render_loop_task())
        pool.step(fetch=True)  # compile outside the timed window
        await asyncio.sleep(1.0)
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        rendered = sum(m.shape[1] for m in got) / SR
        # must make progress but never run far ahead of the wall clock
        # (lower bound generous: CPU render throughput under CI load)
        assert 0.3 < rendered < 2.5, rendered
        assert len(ring) > 0

    asyncio.run(scenario())


# ------------------------------------------------------------- ws end-to-end
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_ws_server_end_to_end():
    import websockets

    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)])
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port)
        fc = FakeController("enc-e2e")
        server.add_transport(fc)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                # on-connect beacons
                beacons = [json.loads(await asyncio.wait_for(ws.recv(), 2)) for _ in range(3)]
                types = {b["type"] for b in beacons}
                assert types == {"serverVersion", "machineStatus", "controllerStatus"}
                await ws.send(json.dumps({"type": "hello", "engineSlots": ["A"]}))

                # hardware encoder turn -> broadcast + pool schedule
                fc.turn("A", "rate", 0.125)
                msg = None
                for _ in range(50):
                    m = json.loads(await asyncio.wait_for(ws.recv(), 2))
                    if m["type"] == "set":
                        msg = m
                        break
                assert msg == {"type": "set", "channel": "A", "engine": "A",
                               "key": "rate", "value": 0.125}
                assert pool.slots[0].timemap.segments[-1].rate == 0.125

                # ws-originated set drives the pool too
                await ws.send(json.dumps({"type": "set", "channel": "A",
                                          "key": "tone", "value": -7}))
                for _ in range(50):
                    m = json.loads(await asyncio.wait_for(ws.recv(), 2))
                    if m["type"] == "set" and m["key"] == "tone":
                        break
                assert pool.slots[0].timemap.segments[-1].semitones == -7.0

                # controllerStatus reflects the attached fake controller
                st = server.controller_status()
                assert st["connected"] is True
                assert st["deviceId"] == "enc-e2e"
                assert st["encoders"]["channels"]["A"]["online"] is True
        finally:
            server.stop()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    asyncio.run(scenario())


def test_concurrent_multi_controller_slots():
    """Two controllers drive slots A and B simultaneously (the shelved
    reference server's semantics: pinned map first, then first-free,
    per-controller pumps — server-multi-for-2-controllers_OLD.py:468-495,
    642-698); detach/reattach preserves the assignment via the pin map."""

    async def scenario():
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.load_track("B", [tone(330.0, int(SR), SR)] * 2)
        server = ControlServer(
            pool=pool, engine_slots=["A", "B"], scan_hardware=False,
            controller_mode="slot", pinned_slots={"enc-two": "B"},
        )
        fc1 = FakeController("enc-one")
        fc2 = FakeController("enc-two")
        server.add_transport(fc1)
        server.add_transport(fc2)
        task = asyncio.create_task(server.serial_manager_task())
        await asyncio.sleep(0.1)
        assert set(server.sessions) == {"enc-one", "enc-two"}
        assert server.allocator.slot_of("enc-one") == "A"
        assert server.allocator.slot_of("enc-two") == "B"

        # both controllers turn their local channel A; routing must land on
        # EACH controller's own slot
        fc1.turn("A", "rate", 0.5)
        fc2.turn("A", "rate", 0.25)
        await asyncio.sleep(0.1)
        seg_a = pool.slots[pool._by_name["A"]].timemap.segments[-1]
        seg_b = pool.slots[pool._by_name["B"]].timemap.segments[-1]
        assert seg_a.rate == 0.5 and seg_b.rate == 0.25

        # status reports both controllers
        status = server.controller_status()
        assert {c["deviceId"]: c["slot"] for c in status["controllers"]} == {
            "enc-one": "A", "enc-two": "B",
        }

        # detach enc-two; enc-one keeps working
        fc2.close()
        await asyncio.sleep(0.2)
        assert set(server.sessions) == {"enc-one"}
        fc1.turn("B", "volume", 50)  # local channel B still routes to slot A
        await asyncio.sleep(0.1)
        assert pool.slots[pool._by_name["A"]].volume == 0.5

        # reattach as a fresh transport with the same deviceId: pin map
        # returns it to slot B even though A..B scan order would differ
        fc2b = FakeController("enc-two")
        server.add_transport(fc2b)
        await asyncio.sleep(2.5)  # next scan tick
        assert server.allocator.slot_of("enc-two") == "B"
        fc2b.turn("A", "tone", -7)
        await asyncio.sleep(0.1)
        seg_b = pool.slots[pool._by_name["B"]].timemap.segments[-1]
        assert seg_b.semitones == -7
        server.stop()
        task.cancel()

    asyncio.run(scenario())


def test_channel_mode_attaches_single_controller():
    """Deployed semantics: one controller max, channels address slots."""

    async def scenario():
        server = ControlServer(engine_slots=["A", "B"], scan_hardware=False)
        server.add_transport(FakeController("enc-a"))
        server.add_transport(FakeController("enc-b"))
        task = asyncio.create_task(server.serial_manager_task())
        await asyncio.sleep(0.1)
        assert len(server.sessions) == 1  # max_controllers defaults to 1
        server.stop()
        task.cancel()

    asyncio.run(scenario())


def test_analyze_surface_ws():
    """A WS client can request scope/spectrum/levels for a playing voice
    (the servable form of reference C13, app/Scope.mjs:398-428)."""
    import websockets

    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        for _ in range(4):
            pool.step()
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port,
                               scan_hardware=False)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            # drain the three on-connect beacons
            for _ in range(3):
                json.loads(await asyncio.wait_for(ws.recv(), 2))
            await ws.send(json.dumps({"type": "analyze", "slot": "A"}))
            msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
            while msg.get("type") != "analysis":
                msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
        assert msg["slot"] == "A"
        assert len(msg["scope"]) > 0 and all(a <= b for a, b in msg["scope"])
        spec = np.asarray(msg["spectrum"])
        hz_per_bin = msg["spectrumHzPerBin"]
        peak_hz = int(np.argmax(spec)) * hz_per_bin
        assert abs(peak_hz - 440.0) < 2.5 * hz_per_bin, peak_hz
        assert msg["levels"]["rms"][0] > 0.0
        server.stop()
        task.cancel()

    asyncio.run(scenario())


def test_pool_pipelined_fetch_matches_blocking():
    """step(fetch="pipeline") returns the same masters as blocking fetch,
    delayed by pipeline_depth steps, with drain() flushing the tail."""

    def run(mode):
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.load_track("B", [tone(330.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=0.8)
        pool.start("B", when=0.0, offset=0.0, rate=1.25, semitones=3)
        masters = []
        for _ in range(10):
            m, _ = pool.step(fetch=mode)
            if m is not None:
                masters.append(np.asarray(m))
        if mode == "pipeline":
            masters.extend(pool.drain())
        return masters

    blocking = run(True)
    pipelined = run("pipeline")
    assert len(blocking) == len(pipelined) == 10
    for a, b in zip(blocking, pipelined):
        np.testing.assert_array_equal(a, b)


def test_status_page_control_surface():
    """GET / serves a control surface: per-channel inputs for the §2.5 key
    space that send `set` over the WS (the reference UI shell's sliders +
    reset buttons, app/multi/index.html:75-186)."""
    import urllib.request

    async def scenario():
        port = _free_port()
        server = ControlServer(pool=_pool(), engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port,
                               scan_hardware=False)
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.3)
        body = (await asyncio.to_thread(
            lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5).read())).decode()
        server.stop()
        task.cancel()
        return body

    body = asyncio.run(scenario())
    assert '["A", "B"]' in body  # slots injected into the page JS
    for key in ("rate", "semitones", "tonalityHz", "formantSemitones",
                "formantBaseHz", "volumePercent", "pan", "blockMs", "overlap"):
        assert f'"{key}"' in body, key
    for frag in ("type:'set'", "type:'analyze'", "msg/s", "buildPanels",
                 # scrolling waveform/spectrogram history strips (the
                 # reference Scope's retained history, app/Scope.mjs:440-610)
                 "drawHistory", "hist-${slot}", "sg-${slot}"):
        assert frag in body, frag
    # the page embeds valid JSON for slots and controls
    import re
    m = re.search(r"const slots = (\[.*?\]);", body)
    assert m and json.loads(m.group(1)) == ["A", "B"]


def test_control_client_request_analysis():
    """ControlClient.request_analysis round-trips the analyze protocol."""
    from bauklank.serve.client import ControlClient

    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        for _ in range(4):
            pool.step()
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port,
                               scan_hardware=False)
        stask = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)
        client = ControlClient(f"ws://127.0.0.1:{port}", engine_slots=["A"])
        ctask = asyncio.create_task(client.run())
        for _ in range(100):
            if client.connected:
                break
            await asyncio.sleep(0.05)
        msg = await client.request_analysis("A")
        assert msg["slot"] == "A" and len(msg["spectrum"]) > 0
        client.stop()
        server.stop()
        ctask.cancel()
        stask.cancel()

    asyncio.run(scenario())


# --------------------------------------------------- playback-position push
def test_rate_clamp_override_and_input_seek():
    """Per-pool rate clamp: multi app caps at 2 (app/multi/app.mjs:483),
    single/dev app at 4 (app/app.mjs:538); and `set input` seeks the
    playback position (the reference slider drag, app/multi/app.mjs:735)."""
    pool = _pool()
    pool.apply_set("A", "rate", 3.5)
    assert pool.slots[0].timemap.segments[-1].rate == 2.0
    dev = StreamPool(capacity=1, sample_rate=SR,
                     config=StretchConfig(channels=2, block=512, interval=128),
                     max_track_sec=2.0, names=["A"], max_rate=4.0)
    dev.apply_set("A", "rate", 3.5)
    assert dev.slots[0].timemap.segments[-1].rate == 3.5
    dev.apply_set("A", "rate", 9.0)
    assert dev.slots[0].timemap.segments[-1].rate == 4.0
    # seek: schedule an input jump 0.1 s ahead of the output clock
    pool.start("A", when=0.0, offset=0.0, rate=1.0)
    assert pool.apply_set("A", "input", 1.5)
    seg = pool.slots[0].timemap.segments[-1]
    assert seg.input == 1.5


def test_time_push_progresses_at_extreme_rate():
    """WS clients receive `{"type":"time",slot,inputTime}` pushes whose
    inputTime progresses during playback at the kiosk's rate 0.001
    (VERDICT r2 item 6; reference worklet post app/SignalsmithStretch.mjs:
    938-942 at the 5 Hz playback-slider cadence app/multi/app.mjs:740-753)."""
    import websockets

    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=0.001)
        sink_chunks = []
        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               ws_host="127.0.0.1", ws_port=port,
                               scan_hardware=False,
                               audio_sink=sink_chunks.append,
                               render_ahead_sec=0.05,
                               time_push_sec=0.05)
        pool.step(fetch=True)  # compile outside the timed window
        task = asyncio.create_task(server.run())
        await asyncio.sleep(0.2)
        times = []
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            end = asyncio.get_event_loop().time() + 3.0
            while asyncio.get_event_loop().time() < end and len(times) < 8:
                try:
                    m = json.loads(await asyncio.wait_for(ws.recv(), 0.5))
                except asyncio.TimeoutError:
                    continue
                if m.get("type") == "time" and m.get("slot") == "A":
                    assert m["engine"] == "A"
                    times.append(m["inputTime"])
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        assert len(times) >= 3, times
        # monotone non-decreasing with real progression, at ~0.001 x output
        assert all(b >= a for a, b in zip(times, times[1:])), times
        assert times[-1] > times[0] > 0.0, times
        assert times[-1] < 0.1  # rate 0.001: input crawls, never runs

    asyncio.run(scenario())


def test_fidelity_render_loop_keeps_event_loop_responsive():
    """VERDICT r2 item 8: pool.step now runs via asyncio.to_thread, so a
    slow (fidelity-engine) step + a slow audio sink cannot stall WS/serial
    handling on the event loop.  Measured: max event-loop tick gap while
    fidelity steps render stays well under one step duration."""
    import time as _time

    async def scenario():
        cfg = StretchConfig(channels=2, block=512, interval=128)
        pool = StreamPool(capacity=2, sample_rate=SR, config=cfg,
                          max_track_sec=2.0, names=["A", "B"],
                          engine="fidelity")
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)

        def slow_sink(master):
            _time.sleep(0.4)  # a laggy DAC boundary (off-loop, thread-safe)

        server = ControlServer(pool=pool, engine_slots=["A", "B"],
                               audio_sink=slow_sink, render_ahead_sec=1.0,
                               scan_hardware=False)
        pool.step(fetch=True)  # compile outside the timed window
        task = asyncio.create_task(server.render_loop_task())
        gaps = []
        t_prev = _time.monotonic()
        end = t_prev + 2.0
        while _time.monotonic() < end:
            await asyncio.sleep(0.01)
            now = _time.monotonic()
            gaps.append(now - t_prev)
            t_prev = now
        server.stop()
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass
        assert pool.out_pos > 0  # rendering actually happened
        # event loop stayed live: a blocking loop would show >= 0.4 s gaps
        # (the sink sleep alone); off-loop stepping keeps ticks short
        assert max(gaps) < 0.3, max(gaps)

    asyncio.run(scenario())
