"""Host -> device double-buffered frame staging, and the overlapped
convert || fetch || emit pipeline that ``bench`` measures.

Counterpart of ``asciichat_tpu/runtime/device_stream.py``. The reference
overlaps decode with rendering through its 3-thread pipeline and bounded
queues (src/common/session/pipeline.c, SURVEY §2e.2); on the card the same
shape overlaps the host-to-device copy with device compute, and the
device-to-host copy of records with the host's ANSI emission.

JAX orders its copies by data dependence. PyTorch does not: a copy on one
stream and a launch on another race unless an event joins them, and the
caching allocator may hand a freed block to the next allocation of its
stream while another stream still reads it. Every hand-off below therefore
goes through a CUDA event, and a record tensor that another stream reads is
``record_stream``-ed onto it. On the CPU the same code runs the plain
versions, with plain copies.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from asciichat_tpu_torch.runtime.double_buffer import LatestFrame


class DeviceFrameStager:
    """Two-slot H2D pipeline: the upload of batch N overlaps compute on N-1.

    Two pinned host slots and two device slots; the copies run on a stream
    of the stager's own. A batch that :meth:`stage` returns stays valid
    until the next :meth:`stage` call, whose copy then reuses its slot (the
    JAX arrays never change; here a slot is overwritten once the work the
    caller enqueued on it before that call has run)."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._host: list[torch.Tensor | None] = [None, None]
        self._dev: list[torch.Tensor | None] = [None, None]
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._next = 0
        self.staged = 0

    def _slot_buffers(self, slot: int, frames: np.ndarray) -> None:
        """(Re)allocate slot ``slot``'s buffers for ``frames``' shape and type."""
        like = torch.from_numpy(np.empty(0, frames.dtype))
        dev = self._dev[slot]
        if dev is None or tuple(dev.shape) != frames.shape or dev.dtype != like.dtype:
            self._dev[slot] = torch.empty(frames.shape, dtype=like.dtype, device=self.device)
            if self._cuda:
                self._host[slot] = torch.empty(frames.shape, dtype=like.dtype, pin_memory=True)

    def _ready(self, slot: int) -> torch.Tensor | None:
        """Slot ``slot``'s device batch, with the caller's current stream
        made to wait on its copy."""
        batch = self._dev[slot]
        if batch is not None and self._cuda and self._copied[slot] is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied[slot])
        return batch

    def stage(self, frames: np.ndarray) -> torch.Tensor | None:
        """Start uploading ``frames``; return the previously staged device
        batch (None on the first call, when nothing is resident yet)."""
        slot = self._next
        self._next = 1 - slot
        if self.staged == 0:
            ready = None
        else:
            ready = self._ready(self._next)  # the other slot: the previous upload
        if not self._cuda:
            self._slot_buffers(slot, frames)
            self._dev[slot].copy_(torch.from_numpy(np.ascontiguousarray(frames)))
            self.staged += 1
            return ready
        if self._copied[slot] is not None:
            # the slot's last copy still reads its pinned buffer
            self._copied[slot].synchronize()
        self._slot_buffers(slot, frames)
        # a non_blocking copy from pageable memory would be synchronous
        self._host[slot].numpy()[...] = frames
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            # what the caller enqueued on this slot's batch runs before the overwrite
            self._stream.wait_stream(caller)
            self._dev[slot].copy_(self._host[slot], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        self.staged += 1
        return ready

    def latest(self) -> torch.Tensor | None:
        """The most recently staged batch; the caller's current stream waits
        on its copy."""
        if self.staged == 0:
            return None
        return self._ready(1 - self._next)

    def flush(self) -> None:
        """Wait until every staged copy has landed."""
        for event in self._copied:
            if event is not None:
                event.synchronize()


class OverlappedRenderPipeline:
    """Run the three serving-path stages concurrently and measure each:

      device convert  ||  D2H record fetch  ||  host ANSI emit

    The reference's 3-thread pipeline shape (src/common/session/pipeline.c:
    206,343, capture/render/send threads over bounded queues) on the card.
    Three host threads:

    - convert: calls ``step_k(frames, ramp)``, which runs ``k`` conversions
      of the ``batch`` frames and returns the last one's record dict, with
      two calls in flight; on the card it launches on a stream of its own
      and hands each set of records on with an event recorded after its
      last launch. ``step_k`` must return records that no later call
      overwrites (fresh tensors, as an eager launch allocates them), since
      the fetch reads them while the next call runs;
    - fetch: copies ``v[:fetch_slice]`` of the latest completed records
      into pinned host buffers on a stream of its own, after waiting on the
      records' event, and hands them on once the copy's event completed;
    - emit: renders ANSI frames from the latest fetched host records with
      ``emit_fn`` (the native emitter releases the GIL).

    Counters give each stage's sustained rate measured under full
    concurrency. The first error in any stage stops the run and is raised.
    """

    def __init__(self, step_k, frames, ramp, emit_fn, *, batch: int, k: int,
                 fetch_slice: int = 8):
        self._step_k = step_k
        self._frames = frames
        self._ramp = ramp
        self._emit_fn = emit_fn
        self._batch = batch
        self._k = k
        self._fetch_slice = fetch_slice
        self._stop = threading.Event()
        # latest-value hand-offs between the stages (the swap the serving
        # path uses, double_buffer.LatestFrame)
        self._dev = LatestFrame()  # latest completed device records, with their event
        self._host = LatestFrame()  # latest fetched host records
        self.converted = 0  # frames converted on the device
        self.fetched = 0  # frames' worth of records copied to the host
        self.fetched_bytes = 0
        self.emitted = 0  # ANSI frames emitted
        self.errors: list[BaseException] = []
        self._threads: list[threading.Thread] = []

    def _device(self) -> torch.device | None:
        dev = getattr(self._frames, "device", None)
        return dev if dev is not None and dev.type == "cuda" else None

    # -- stage loops -------------------------------------------------------
    def _convert_loop(self, stream: torch.cuda.Stream | None) -> None:
        try:
            with _on(stream):
                inflight = []
                while not self._stop.is_set():
                    recs = self._step_k(self._frames, self._ramp)
                    done = None
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                    inflight.append((recs, done))
                    if len(inflight) >= 2:  # two calls in flight: wait for the older
                        recs0, done0 = inflight.pop(0)
                        if done0 is not None:
                            done0.synchronize()
                        self._dev.commit((recs0, done0))
                        self.converted += self._batch * self._k
                for _recs0, done0 in inflight:
                    if done0 is not None:
                        done0.synchronize()
                    self.converted += self._batch * self._k
        except BaseException as e:  # raised by run()
            self.errors.append(e)
            self._stop.set()

    def _fetch_loop(self, stream: torch.cuda.Stream | None) -> None:
        try:
            n = self._fetch_slice
            with _on(stream):
                while not self._stop.is_set():
                    item, _seq, _ts = self._dev.latest()
                    if item is None:
                        time.sleep(0.002)
                        continue
                    recs, done = item
                    if stream is None:
                        host = {k: np.ascontiguousarray(v[:n].numpy()) for k, v in recs.items()}
                    else:
                        stream.wait_event(done)
                        pinned = {}
                        for k, v in recs.items():
                            part = v[:n]
                            part.record_stream(stream)  # the allocator waits for this copy
                            pinned[k] = torch.empty(part.shape, dtype=part.dtype,
                                                    pin_memory=True)
                            pinned[k].copy_(part, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(stream)
                        copied.synchronize()
                        host = {k: v.numpy() for k, v in pinned.items()}
                    self._host.commit(host)
                    # rows actually copied: with batch < fetch_slice the slice
                    # clamps, and crediting n would overstate d2h_fps
                    self.fetched += min(a.shape[0] for a in host.values())
                    self.fetched_bytes += sum(a.nbytes for a in host.values())
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()

    def _emit_loop(self) -> None:
        try:
            while not self._stop.is_set():
                host, _seq, _ts = self._host.latest()
                if host is None:
                    time.sleep(0.002)
                    continue
                out = self._emit_fn(host)
                self.emitted += len(out)
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()

    def _thread(self, target, name: str, *args) -> threading.Thread:
        dev = self._device()

        def run():
            if dev is not None:  # the current device is per thread
                torch.cuda.set_device(dev)
            target(*args)

        return threading.Thread(target=run, daemon=True, name=name)

    # -- the run -----------------------------------------------------------
    def run(self, seconds: float, warmup: float = 1.0) -> dict:
        """Run all stages concurrently; return per-stage rates over the
        steady-state window (after ``warmup``). Each call starts a fresh
        measurement; a thread of an earlier run that is still alive (it
        outlived its join timeout) would count into this run, so the call
        refuses to start."""
        stale = [t for t in self._threads if t.is_alive()]
        if stale:
            raise RuntimeError(
                f"previous run's threads still alive: {[t.name for t in stale]}")
        self._stop.clear()
        self.errors.clear()
        self._dev = LatestFrame()
        self._host = LatestFrame()
        dev = self._device()
        convert_stream = torch.cuda.Stream(dev) if dev is not None else None
        fetch_stream = torch.cuda.Stream(dev) if dev is not None else None
        self._threads = [
            self._thread(self._convert_loop, "pipeline-convert", convert_stream),
            self._thread(self._fetch_loop, "pipeline-fetch", fetch_stream),
            self._thread(self._emit_loop, "pipeline-emit"),
        ]
        for t in self._threads:
            t.start()
        deadline = time.monotonic() + warmup
        while time.monotonic() < deadline and not self._stop.is_set():
            time.sleep(0.01)
        c0, f0, e0, b0 = self.converted, self.fetched, self.emitted, self.fetched_bytes
        t0 = time.monotonic()
        deadline = t0 + seconds
        while time.monotonic() < deadline and not self._stop.is_set():
            time.sleep(0.01)
        dt = time.monotonic() - t0
        rates = {
            "convert_fps": (self.converted - c0) / dt,
            "d2h_fps": (self.fetched - f0) / dt,
            "d2h_mbps": (self.fetched_bytes - b0) / dt / 1e6,
            "emit_fps": (self.emitted - e0) / dt,
            "seconds": dt,
        }
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        if self.errors:
            raise self.errors[0]
        return rates


def _on(stream: torch.cuda.Stream | None):
    """The stream's context on the card; nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
