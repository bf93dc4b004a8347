"""The port's JAX-free host planners and plain filters against the JAX
package's own functions: composite layout and gather maps, filter registry,
rainbow tints and the colour filter. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import compositor as jcomp
from asciichat_tpu.ops import filters as jfilt
from asciichat_tpu_torch.ops import compositor as tcomp
from asciichat_tpu_torch.ops import filters as tfilt

from conftest import synthetic_frame


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (source sizes (w, h), terminal columns, terminal rows)
LAYOUTS = [
    ([(640, 480)], 80, 24),
    ([(640, 480)] * 2, 120, 40),
    ([(800, 600)] * 9, 203, 64),
    ([(1280, 720), (640, 480), (480, 640)], 160, 50),
    ([(320, 240)] * 4, 40, 12),
    ([(0, 0), (640, 480)], 100, 30),  # a degenerate source composes nothing
    ([(10, 4000), (640, 480)], 100, 30),  # extreme aspect
    ([], 80, 24),
    ([(640, 480)] * 12, 203, 64),  # more than MAX_COMPOSITE_SOURCES
    ([(640, 480)] * 5, 30, 5),  # tiny terminal
]


def test_constants_and_registry_match():
    assert tcomp.MAX_COMPOSITE_SOURCES == jcomp.MAX_COMPOSITE_SOURCES
    assert tcomp.PIXELS_PER_CHAR_HEIGHT == jcomp.PIXELS_PER_CHAR_HEIGHT
    assert tfilt.FILTER_REGISTRY == jfilt.FILTER_REGISTRY
    assert tfilt.FILTER_NAMES == jfilt.FILTER_NAMES
    assert tfilt.RAINBOW_MIN_BRIGHTNESS == jfilt.RAINBOW_MIN_BRIGHTNESS


@pytest.mark.parametrize("sizes,term_w,term_h", LAYOUTS)
def test_plan_composite_matches_jax(sizes, term_w, term_h):
    assert (tcomp.optimal_grid_layout(sizes, term_w, term_h)
            == jcomp.optimal_grid_layout(sizes, term_w, term_h))
    a = jcomp.plan_composite(sizes, term_w, term_h)
    b = tcomp.plan_composite(sizes, term_w, term_h)
    assert (a.width_px, a.height_px, a.cols, a.rows) == (
        b.width_px, b.height_px, b.cols, b.rows)
    for name in ("client_idx", "src_y", "src_x"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert getattr(a, name).dtype == getattr(b, name).dtype
    for x, y in zip(jcomp.host_maps(a), tcomp.host_maps(b), strict=True):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype and x.shape == y.shape


@pytest.mark.parametrize("sizes,term_w,term_h", LAYOUTS[:5])
def test_composite_gather_matches_jax(sizes, term_w, term_h):
    hmax = max(h for _, h in sizes)
    wmax = max(w for w, _ in sizes)
    frames = np.stack([synthetic_frame(hmax, wmax, seed=i) for i in range(len(sizes))])
    a = jcomp.plan_composite(sizes, term_w, term_h)
    b = tcomp.plan_composite(sizes, term_w, term_h)
    want = np.asarray(jcomp.composite_gather(jnp.asarray(frames), a))
    maps = [torch.from_numpy(m) for m in tcomp.host_maps(b)]
    got = tcomp.composite_gather(torch.from_numpy(frames), *maps).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcomp.composite_reference(frames, b),
                                  jcomp.composite_reference(frames, a))


TIMES = [0.0, 0.3, 1.0, 1.75, 2.9, 3.49, 3.5, 7.1, 1234.567, 1e6 + 0.123,
         -0.2, -1.0, -3.6, -100.25]


def test_rainbow_color_matches_jax_densely():
    """The port computes the rainbow tint in Python floats rounded to
    float32 at every step; the JAX package's copy in numpy float32 scalars.
    Equal over dense and random times, negative ones included."""
    rng = np.random.default_rng(0)
    times = np.concatenate([np.arange(-7.0, 7.0, 0.0007), rng.uniform(-100, 100, 5000),
                            rng.uniform(0, 1e6, 5000), [-0.0, 1e-30, -1e-30, 123456789.5]])
    bad = [t for t in times.tolist() if tfilt.rainbow_color(t) != jfilt.rainbow_color(t)]
    assert not bad, bad[:5]


@pytest.mark.parametrize("time_s", TIMES)
def test_rainbow_and_filter_params_match_jax(time_s):
    assert tfilt.rainbow_color(time_s) == jfilt.rainbow_color(time_s)
    names = tfilt.FILTER_NAMES + ["rainbow", "none"]
    for a, b in zip(jfilt.filter_params(names, time_s),
                    tfilt.filter_params(names, time_s), strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("name", tfilt.FILTER_NAMES)
def test_color_filter_matches_jax(name):
    frame = synthetic_frame(23, 31, seed=4)
    np.testing.assert_array_equal(
        tfilt.apply_color_filter_reference(frame, name, 1.3),
        jfilt.apply_color_filter_reference(frame, name, 1.3))


def test_batched_color_filter_matches_jax():
    names = tfilt.FILTER_NAMES
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (len(names), 9, 13, 3), dtype=np.uint8)
    params = tfilt.filter_params(names, 2.6)
    want = np.asarray(jfilt.apply_color_filter(
        jnp.asarray(frames), *(jnp.asarray(p) for p in params)))
    got = tfilt.apply_color_filter(torch.from_numpy(frames),
                                   *(torch.from_numpy(p) for p in params))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
