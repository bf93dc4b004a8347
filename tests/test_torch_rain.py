"""The port's digital rain (ops/rain.py, FrameTransform, the mirror's ``m``
key and ``--matrix``) against the JAX package's, on the CPU.

Parity is not bit for bit: XLA's CPU ``sin`` is its own approximation and
XLA contracts multiply-adds, so the field differs from torch's in the last
bits. The bound, fixed before the port was written: call a pixel a wrap
pixel where JAX's ``wob`` lies within 1e-4 of an integer (there the sawtooth
may wrap on one side only). Outside wrap pixels the port's field stays within
1e-4 absolute of JAX's and its overlaid uint8 frame within 1 of JAX's; wrap
pixels are at most 0.05% of a test window's pixels (a window: every frame of
one sweep of times); and the ANSI bytes that the port renders from its own
overlaid frame equal the oracle's for that frame, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import rain as jrain
from asciichat_tpu.render import oracle
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.models.mirror import MirrorSession
from asciichat_tpu_torch.models.session import FrameTransform
from asciichat_tpu_torch.ops import rain as train
from asciichat_tpu_torch.render.pipeline import AsciiRenderer

CPU = torch.device("cpu")
FIELD_TOL = 1e-4  # absolute, outside wrap pixels
WRAP_DIST = 1e-4  # |wob - round(wob)| below this makes a wrap pixel
WRAP_SHARE = 5e-4  # at most 0.05% of a window's pixels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def wrap_pixels(jax_field: np.ndarray) -> np.ndarray:
    """Where JAX's ``wob`` lies within WRAP_DIST of an integer. The field is
    1 - fract(wob), and fract(wob) = wob - floor(wob) is exact in float32, so
    1 - field gives fract(wob) to within 6e-8 and the distance to the nearest
    integer is the smaller of it and 1 minus it."""
    fract = 1.0 - jax_field.astype(np.float64)
    return np.minimum(fract, 1.0 - fract) < WRAP_DIST


def test_column_tables_equal_jax():
    for cols in (1, 203, 1920):
        j, t = jrain.DigitalRain(cols, 4), train.DigitalRain(cols, 4)
        np.testing.assert_array_equal(t.time_offset.numpy(), np.asarray(j.time_offset))
        np.testing.assert_array_equal(t.speed_multiplier.numpy(),
                                      np.asarray(j.speed_multiplier))


@pytest.mark.parametrize("rows,cols,t0,t1", [(64, 203, 0.0, 120.0), (37, 101, 500.0, 620.0)])
def test_field_and_overlay_within_the_bound(rows, cols, t0, t1):
    """200 times over the window, a seeded frame at each."""
    j, t = jrain.DigitalRain(cols, rows), train.DigitalRain(cols, rows)
    rng = np.random.default_rng(rows)
    wraps = field_err = frame_err = 0
    times = np.linspace(t0, t1, 200)
    for k, sim in enumerate(times):
        jf = np.asarray(j.brightness_field(float(sim)))
        tf = t.brightness_field(float(sim)).numpy()
        assert tf.shape == jf.shape == (rows, cols) and tf.dtype == np.float32
        wrap = wrap_pixels(jf)
        wraps += int(wrap.sum())
        field_err = max(field_err, float(np.abs(tf - jf)[~wrap].max()))
        frame = rng.integers(0, 256, (rows, cols, 3), dtype=np.uint8)
        jo = np.asarray(j.apply(jnp.asarray(frame), float(sim))).astype(np.int16)
        to = t.apply(torch.from_numpy(frame), float(sim)).numpy()
        assert to.dtype == np.uint8 and to.shape == frame.shape
        frame_err = max(frame_err, int(np.abs(to.astype(np.int16) - jo)[~wrap].max()))
    assert field_err <= FIELD_TOL, field_err
    assert frame_err <= 1, frame_err
    assert wraps <= WRAP_SHARE * rows * cols * len(times), wraps


def test_overlay_refuses_a_field_of_another_size():
    rain = train.DigitalRain(8, 6)
    with pytest.raises(ValueError, match="does not match"):
        rain.apply(torch.zeros((7, 8, 3), dtype=torch.uint8), 1.0)


@pytest.mark.parametrize("caps", [
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
], ids=lambda c: c.renderer_key())
def test_bytes_from_the_overlaid_frame_equal_the_oracle(caps):
    frame = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    over = train.DigitalRain(64, 48).apply(torch.from_numpy(frame), 7.25).numpy()
    got = AsciiRenderer(device=CPU).convert(over, 40, 12, caps)
    assert got == oracle.ascii_convert_with_capabilities(over, 40, 12, caps)


def test_rain_is_rebuilt_when_either_dimension_changes():
    ft = FrameTransform(matrix=True, device=CPU)
    frame = np.zeros((20, 30, 3), np.uint8)
    assert tuple(ft(frame).shape) == (20, 30, 3)
    first = ft._rain
    assert (first.num_rows, first.num_columns) == (20, 30)
    assert ft(frame) is not None and ft._rain is first  # same size: kept
    out = ft(np.zeros((24, 30, 3), np.uint8))  # height only
    assert tuple(out.shape) == (24, 30, 3)
    assert ft._rain is not first and (ft._rain.num_rows, ft._rain.num_columns) == (24, 30)
    ft(np.zeros((24, 31, 3), np.uint8))  # width only
    assert (ft._rain.num_rows, ft._rain.num_columns) == (24, 31)


def test_rain_then_filter_and_fit_on_the_host():
    """With a colour filter or an upload fit after it, the rain's frame
    comes back to the host as numpy."""
    frame = np.random.default_rng(4).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    ft = FrameTransform(matrix=True, color_filter="green", device=CPU)
    out = ft(frame)
    assert isinstance(out, np.ndarray) and out.shape == (40, 50, 3)
    ft = FrameTransform(matrix=True, max_upload=(25, 20), device=CPU)
    out = ft(frame)
    assert isinstance(out, np.ndarray) and out.shape[0] <= 20 and out.shape[1] <= 25


class _StillSource:
    fps = 30.0

    def __init__(self, frame):
        self.frame = frame

    def read(self):
        return self.frame

    def close(self):
        pass


def test_m_key_toggles_the_rain():
    frame = np.random.default_rng(5).integers(0, 256, (36, 48, 3), dtype=np.uint8)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    session = MirrorSession(_StillSource(frame), caps, 24, 8, pal.DEFAULT_PALETTE, device=CPU)
    assert session.matrix is False
    plain = session.run_snapshot()
    assert plain == oracle.ascii_convert_with_capabilities(frame, 24, 8, caps)
    session._on_key("m")
    assert session.matrix is True and session.transform.matrix is True
    seen = []
    convert = session.renderer.convert
    session.renderer.convert = lambda f, *a, **k: seen.append(np.asarray(f)) or convert(f, *a, **k)
    rained = session.run_snapshot()
    over = seen[-1]
    assert rained != plain
    assert (over[..., 0] <= over[..., 1]).all()  # rain-coloured: green over red
    assert rained == oracle.ascii_convert_with_capabilities(over, 24, 8, caps)
    session._on_key("m")
    assert session.matrix is False and session.run_snapshot() == plain


def test_mirror_properties_are_the_transforms():
    session = MirrorSession(_StillSource(None), TerminalCapabilities(), 10, 4,
                            pal.DEFAULT_PALETTE, device=CPU)
    session.flip_x, session.color_filter = True, "cyan"
    assert session.transform.flip_x is True and session.transform.color_filter == "cyan"
    session._on_key("f")
    session._on_key("c")
    assert session.flip_x is False and session.color_filter == "orange"
    assert session.writer is session.display.writer
