"""The port's client writes its frames on a display thread
(asciichat_tpu_torch/models/session.DisplayThread), never on its event loop.

A client whose stdout blocks in ``write`` until released (a pipe whose
reader lags) goes on playing its downlink audio and sending its keepalive
PING; after the release the last frame it received is written, and the quit
key ends run(). Then DisplayThread alone: a reset never overtakes the frame
committed before it, a lagging stream skips stale frames, chat lines keep
their order and past MAX_CHAT are dropped, and stop() gives up on a stream
that never drains after its limit. No fixed sleeps: every wait polls for its
condition under LIMIT seconds."""

import asyncio
import threading
import time

import numpy as np
import pytest

from asciichat_tpu_torch.apps import client as client_mod
from asciichat_tpu_torch.apps.client import AsciiChatClient
from asciichat_tpu_torch.models.session import DisplaySink, DisplayThread
from asciichat_tpu_torch.net import packet as pkt

P = pkt.PacketType
LIMIT = 30.0  # seconds for any one condition


def _until(cond, what: str, limit: float = LIMIT) -> None:
    end = time.monotonic() + limit
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


class _BlockingStream:
    """A stdout whose ``write`` blocks until ``release`` is set."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.data = bytearray()

    def write(self, b: bytes) -> int:
        self.entered.set()
        if not self.release.wait(2 * LIMIT):
            raise OSError("the test never released the stream")
        self.data += b
        return len(b)

    def flush(self) -> None:
        pass

    def isatty(self) -> bool:
        return False


class _Feed:
    """A server as a transport: an AUDIO_BATCH every 5 ms and an ASCII_FRAME
    every fourth packet (``frame <k>``), until ``last`` is set, which is
    sent once as the final frame; what the client sends is recorded."""

    def __init__(self):
        self.sent: list[int] = []
        self.frames_sent = 0
        self.last: bytes | None = None
        self._last_sent = False
        self._n = 0
        self.closed = False

    async def recv(self):
        if self.closed:
            raise asyncio.IncompleteReadError(b"", 1)
        await asyncio.sleep(0.005)
        self._n += 1
        if self.last is not None and not self._last_sent:
            self._last_sent = True
            return self._frame(self.last)
        if self.last is None and self._n % 4 == 0:
            return self._frame(b"frame %d" % self.frames_sent)
        tone = (0.1 * np.sin(np.arange(480) / 7)).astype("<f4")
        return int(P.AUDIO_BATCH), pkt.pack_audio_batch(tone.tobytes(), 480, 1)

    def _frame(self, body: bytes):
        self.frames_sent += 1
        return int(P.ASCII_FRAME), pkt.pack_ascii_frame(body, 8, 1, compress=False)

    async def send(self, ptype, payload=b"", **kw):
        self.sent.append(int(ptype))

    def send_nowait(self, ptype, payload=b"", **kw):
        self.sent.append(int(ptype))

    async def close(self):
        self.closed = True


class _Sink:
    """An audio sink that counts the samples it is given."""

    def __init__(self):
        self.samples = 0

    def write(self, mix) -> None:
        self.samples += len(mix)

    def close(self) -> None:
        pass


def test_blocked_stdout_does_not_stop_audio_or_keepalive(monkeypatch):
    """The client runs in this thread (its SIGWINCH handler needs the main
    one); a watcher thread holds it to the three conditions and then, pass
    or fail, releases the stream and presses the quit key."""
    feed = _Feed()

    async def connect(host, port):
        return feed

    monkeypatch.setattr(client_mod, "connect_tcp", connect)
    monkeypatch.setattr(client_mod, "KEEPALIVE_INTERVAL", 0.2)
    sink, stream = _Sink(), _BlockingStream()
    c = AsciiChatClient("127.0.0.1", 1, reconnect=False, audio_sink=sink)
    c.display = DisplaySink(stream=stream)
    failure: list[BaseException] = []

    def watch():
        try:
            _until(stream.entered.is_set, "the first frame's write to block")
            samples, pings = sink.samples, feed.sent.count(int(P.PING))
            _until(lambda: sink.samples >= samples + 48_000,
                   "a second of downlink audio while the write is blocked")
            _until(lambda: feed.sent.count(int(P.PING)) >= pings + 2,
                   "two keepalive PINGs while the write is blocked")
            feed.last = b"the last frame"
            _until(lambda: feed._last_sent and c.frames_received == feed.frames_sent,
                   "the last frame to be received")
        except Exception as e:  # raised in the test's thread
            failure.append(e)
        finally:
            stream.release.set()
            _until(lambda: c._loop is not None, "the client's loop")
            c._on_key("q")

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    asyncio.run(asyncio.wait_for(c.run(), 6 * LIMIT))
    watcher.join(LIMIT)
    assert not watcher.is_alive()
    if failure:
        raise failure[0]
    assert stream.data.startswith(b"frame 0\n")  # the write that blocked
    assert stream.data.endswith(b"the last frame\n")  # drained at the stop
    assert c.frames_received == feed.frames_sent


class _Recorder:
    """A stdout that keeps each write; while ``gate`` is clear a write
    waits for it. ``entered`` counts the writes begun."""

    def __init__(self, gate: threading.Event | None = None, tty: bool = True):
        self.gate = gate
        self.tty = tty  # a tty's frames start at the cursor's home, the first with a clear
        self.chunks: list[bytes] = []
        self.entered = 0

    def write(self, b: bytes) -> int:
        self.entered += 1
        if self.gate is not None and not self.gate.wait(2 * LIMIT):
            raise OSError("the test never opened the gate")
        self.chunks.append(bytes(b))
        return len(b)

    def flush(self) -> None:
        pass

    def isatty(self) -> bool:
        return self.tty


CLEAR, HOME = b"\x1b[2J", b"\x1b[H"


def _blocked_after_z(rec: _Recorder, gate: threading.Event) -> DisplayThread:
    """A started display that has written frame Z and is now blocked in the
    write of frame X."""
    screen = DisplayThread(DisplaySink(stream=rec))
    screen.start()
    screen.commit(b"Z")
    _until(lambda: any(w.endswith(b"Z") for w in rec.chunks), "frame Z")
    gate.clear()
    screen.commit(b"X")
    _until(lambda: rec.entered > len(rec.chunks), "frame X's write to block")
    return screen


def test_reset_is_written_after_the_frame_before_it():
    """The reset's frame A is still the latest when the thread gets to the
    reset: A is written first, with no clear, then the frame after the
    reset, C, with the clear."""
    gate = threading.Event()
    gate.set()
    rec = _Recorder(gate)
    screen = _blocked_after_z(rec, gate)
    try:
        screen.commit(b"A")
        screen.call(screen.sink.reset)
        gate.set()
        _until(lambda: screen.sink.writer._first, "the reset")
        screen.commit(b"C")
    finally:
        gate.set()
        assert screen.stop(LIMIT)
    frames = [w for w in rec.chunks if w[-1:] in (b"Z", b"X", b"A", b"C")]
    assert frames == [CLEAR + HOME + b"Z", HOME + b"X", HOME + b"A", CLEAR + HOME + b"C"]


def test_frames_replaced_behind_a_reset_and_a_chat_line_keep_the_order():
    """While the write of X blocks: A, the reset, B, a chat line, C. A and B
    are replaced before the thread gets to them (skipped); C comes after
    the reset (so with the clear) and after the chat line."""
    gate = threading.Event()
    gate.set()
    rec = _Recorder(gate)
    screen = _blocked_after_z(rec, gate)
    try:
        screen.commit(b"A")
        screen.call(screen.sink.reset)
        screen.commit(b"B")
        screen.chat_line(b"hi")
        screen.commit(b"C")
    finally:
        gate.set()
        assert screen.stop(LIMIT)
    frames = [w for w in rec.chunks if w[-1:] in (b"Z", b"X", b"A", b"B", b"C")]
    assert frames == [CLEAR + HOME + b"Z", HOME + b"X", CLEAR + HOME + b"C"]
    chat = next(i for i, w in enumerate(rec.chunks) if b"> hi" in w)
    assert rec.chunks.index(HOME + b"X") < chat < rec.chunks.index(CLEAR + HOME + b"C")


def test_lagging_stream_skips_stale_frames_and_drains_the_last():
    gate = threading.Event()
    rec = _Recorder(gate, tty=False)
    screen = DisplayThread(DisplaySink(stream=rec))
    screen.start()
    try:
        screen.commit(b"frame 0")
        _until(lambda: rec.entered, "the first write to block")
        for k in range(1, 200):
            screen.commit(b"frame %d" % k)
    finally:
        gate.set()
        assert screen.stop(LIMIT)
    assert rec.chunks[0] == b"frame 0\n" and rec.chunks[-1] == b"frame 199\n"
    assert len(rec.chunks) <= 3  # 0, perhaps one in between, 199
    assert screen.sink.frames_written == len(rec.chunks)


def test_chat_lines_past_the_cap_are_dropped():
    gate = threading.Event()
    rec = _Recorder(gate)
    screen = DisplayThread(DisplaySink(stream=rec))
    screen.start()
    try:
        _until(lambda: rec.entered, "setup's write to block")  # hide-cursor
        for k in range(DisplayThread.MAX_CHAT + 5):
            screen.chat_line(b"line %d" % k)
    finally:
        gate.set()
        assert screen.stop(LIMIT)
    lines = [w for w in rec.chunks if b"> line" in w]
    assert len(lines) == DisplayThread.MAX_CHAT and screen.chat_dropped == 5
    assert lines[0].endswith(b"> line 0\r\n")
    assert lines[-1].endswith(b"> line %d\r\n" % (DisplayThread.MAX_CHAT - 1))


def test_stop_gives_up_on_a_stream_that_never_drains():
    gate = threading.Event()
    rec = _Recorder(gate)
    screen = DisplayThread(DisplaySink(stream=rec))
    screen.start()
    try:
        screen.commit(b"stuck")
        _until(lambda: rec.entered, "the write to block")
        t0 = time.monotonic()
        assert not screen.stop(0.2)
        assert time.monotonic() - t0 < LIMIT
    finally:
        gate.set()
    screen._thread.join(LIMIT)
    assert not screen._thread.is_alive()


@pytest.mark.parametrize("exc", [BrokenPipeError, ValueError])
def test_a_broken_stream_is_counted_not_raised(exc):
    class Broken(_Recorder):
        def write(self, b):
            raise exc("gone")

    screen = DisplayThread(DisplaySink(stream=Broken()))
    screen.start()
    screen.commit(b"x")
    screen.chat_line(b"y")
    assert screen.stop(LIMIT)
    assert screen.write_failures >= 2  # setup, the frame, the chat line, teardown
