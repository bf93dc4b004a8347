"""The port's runtime/device_stream.py on the CPU: the cases of
tests/test_pipeline_overlap.py (all three stages progress together, the
emitted bytes under full concurrency are the oracle's, the first error stops
the run and is raised), test_runtime_native.py::test_device_frame_stager and
test_review_r04.py::test_pipeline_run_refuses_stale_threads. The card's
streams and events run in test_torch_kernels.py (marker ``gpu``) and in
``bench`` on the card (chip_smoke.py)."""

import threading

import numpy as np
import pytest
import torch

from asciichat_tpu.render import oracle
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.ops import cells
from asciichat_tpu_torch.render import emitter
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import plan_render
from asciichat_tpu_torch.runtime.device_stream import DeviceFrameStager, OverlappedRenderPipeline

CAPS = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _make_pipeline(fail_emit=False, fail_convert=False):
    b, src_h, src_w, k = 4, 48, 64, 3
    plan = plan_render(src_w, src_h, 24, 8, CAPS)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (b, src_h, src_w, 3), np.uint8))
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    want = [oracle.ascii_convert_with_capabilities(frames[i].numpy(), 24, 8, CAPS)
            for i in range(2)]
    wrong = []  # emitted frames that were not the oracle's

    def step_records(f, r):
        if fail_convert:
            raise RuntimeError("convert fault")
        for _ in range(k - 1):
            cells.render_cells(f, r, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode)
        return cells.render_cells(f, r, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode)

    def emit(host):
        if fail_emit:
            raise RuntimeError("boom")
        out = emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w,
                                  pad_h=plan.pad_h, nthreads=1, copy=False)
        wrong.extend(i for i, o in enumerate(out) if bytes(o) != want[i])
        return out

    pipe = OverlappedRenderPipeline(step_records, frames, ramp, emit, batch=b, k=k,
                                    fetch_slice=2)
    return pipe, plan, want, wrong


def test_all_stages_progress_concurrently():
    pipe, plan, want, wrong = _make_pipeline()
    rates = pipe.run(seconds=1.5, warmup=0.5)
    assert rates["convert_fps"] > 0, rates
    assert rates["d2h_fps"] > 0, rates
    assert rates["emit_fps"] > 0, rates
    assert rates["d2h_mbps"] > 0 and 1.4 < rates["seconds"] < 3.0, rates
    assert pipe.emitted > 0 and wrong == []  # every frame emitted under concurrency
    # the last fetched records, re-emitted, are the oracle's bytes
    host, _seq, _ts = pipe._host.latest()
    assert set(host) == {"rgb", "luma"} and host["rgb"].shape[0] == 2
    out = emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE,
                              pad_w=plan.pad_w, pad_h=plan.pad_h)
    assert out == want
    # run() is reusable: a second run measures afresh
    again = pipe.run(seconds=0.5, warmup=0.1)
    assert again["convert_fps"] > 0 and again["emit_fps"] > 0, again


@pytest.mark.parametrize("fault", ["emit", "convert"])
def test_stage_error_stops_pipeline_and_raises(fault):
    pipe, _, _, _ = _make_pipeline(fail_emit=fault == "emit", fail_convert=fault == "convert")
    with pytest.raises(RuntimeError, match="boom" if fault == "emit" else "convert fault"):
        pipe.run(seconds=5.0, warmup=0.1)
    assert not any(t.is_alive() for t in pipe._threads)


def test_pipeline_run_refuses_stale_threads():
    """A thread of a previous run that outlived its join timeout would wake
    when the stop flag clears and count into the new run: refuse."""
    pipe = OverlappedRenderPipeline(lambda f, r: {}, None, None, lambda h: [], batch=1, k=1)
    gate = threading.Event()
    t = threading.Thread(target=gate.wait, name="stale-convert", daemon=True)
    t.start()
    pipe._threads = [t]
    try:
        with pytest.raises(RuntimeError, match="still alive"):
            pipe.run(0.1, warmup=0.0)
    finally:
        gate.set()
        t.join(timeout=5)
    assert not t.is_alive()


def test_device_frame_stager():
    stager = DeviceFrameStager(CPU)
    a = np.full((2, 4, 4, 3), 1, np.uint8)
    b = np.full((2, 4, 4, 3), 2, np.uint8)
    c = np.full((2, 4, 4, 3), 3, np.uint8)
    assert stager.latest() is None
    assert stager.stage(a) is None  # nothing resident yet
    got = stager.stage(b)
    np.testing.assert_array_equal(got.numpy(), a)  # previous batch ready
    got = stager.stage(c)
    np.testing.assert_array_equal(got.numpy(), b)
    np.testing.assert_array_equal(stager.latest().numpy(), c)
    assert stager.staged == 3
    stager.flush()
    # another shape: the slot's buffers follow it
    d = np.arange(3 * 5 * 6 * 3, dtype=np.uint8).reshape(3, 5, 6, 3)
    got = stager.stage(d)
    np.testing.assert_array_equal(got.numpy(), c)
    assert stager.latest().shape == d.shape and stager.latest().device == CPU
    np.testing.assert_array_equal(stager.latest().numpy(), d)
