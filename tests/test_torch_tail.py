"""The library tail of the port against the JAX package's.

``ops/pixel.py``'s flip, colour-level quantizer and ordered dither must give
the JAX functions' bytes exactly (integer math, widened to int32 before the
adds: torch's uint8 wraps). ``ops/audio.py``'s lowpass, resampler and level
analysis agree within rtol=2e-4, atol=2e-5, the bound tests/test_audio.py
holds the JAX mixer to: XLA on the CPU contracts multiply-adds and sums in
its own order. The JAX package's tests of the four host copies
(``render/validator.py``, ``utils/framefd.py``, ``utils/lifecycle.py``,
``web/jsrun.py``) run on the port's modules through ``port_jax_tests``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asciichat_tpu.ops import audio as jaudio
from asciichat_tpu.ops import pixel as jpixel
from asciichat_tpu_torch.ops import audio, pixel

from test_torch_webrtc import port_jax_tests

TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_audio.py:111

port_jax_tests(globals(), "test_subsystems.py", only={
    "test_frame_validator", "test_lifecycle_once_and_shutdown"})
port_jax_tests(globals(), "test_review_r04.py", only={
    "test_validator_terminal_semantics", "test_lifecycle_shutdown_runs_hooks_before_clearing",
    "test_framefd_survives_short_reads_and_flags_trailing_garbage"})
# the browser client's JavaScript under the Qt V4 engine, through the port's
# web/jsrun.py and its web/ assets
port_jax_tests(globals(), "test_webclient.py", only={
    "test_qjs_engine_available", "test_js_parser_matches_committed_corpus_qjs",
    "test_js_acip_wire_interop_qjs", "test_renderer_js_pixel_path_bytes_qjs",
    "test_renderer_js_cell_diff_path_qjs", "test_js_parser_fuzz_lockstep_with_python_twin_qjs",
    "test_app_js_connect_caps_dispatch_qjs", "test_app_js_reconnect_backoff_qjs",
    "test_app_js_webrtc_signaling_success_qjs", "test_app_js_webrtc_fallback_to_websocket_qjs",
    "test_app_js_bench_local_qjs", "test_app_js_audio_and_camera_uplink_qjs"})


def _frames(seed: int, shape=(2, 5, 37, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("flip_x", [False, True])
@pytest.mark.parametrize("flip_y", [False, True])
def test_flip_like_jax(flip_x, flip_y):
    f = _frames(1)
    want = np.asarray(jpixel.flip(jnp.asarray(f), flip_x, flip_y))
    np.testing.assert_array_equal(pixel.flip(torch.from_numpy(f), flip_x, flip_y).numpy(), want)


@pytest.mark.parametrize("levels", [1, 2, 3, 7, 16, 100, 255, 256])
def test_quantize_color_levels_like_jax(levels):
    f = _frames(2)
    want = np.asarray(jpixel.quantize_color_levels(jnp.asarray(f), levels))
    got = pixel.quantize_color_levels(torch.from_numpy(f), levels)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [0, -1, 257])
def test_quantize_color_levels_guard(levels):
    f = torch.from_numpy(_frames(3))
    with pytest.raises(ValueError, match="1..256"):
        pixel.quantize_color_levels(f, levels)
    with pytest.raises(ValueError, match="1..256"):
        jpixel.quantize_color_levels(jnp.asarray(f.numpy()), levels)


@pytest.mark.parametrize("strength", [0, 1, 5, 16, 64, 255])
def test_ordered_dither_like_jax(strength):
    f = _frames(4, (2, 3, 41, 3))
    f[0] = 250  # saturates: uint8 arithmetic would wrap
    want = np.asarray(jpixel.ordered_dither(jnp.asarray(f), strength))
    got = pixel.ordered_dither(torch.from_numpy(f), strength)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pixel._BAYER16, jpixel._BAYER16)


def _audio(seed: int, shape=(3, 480)) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.3, shape).astype(np.float32)


@pytest.mark.parametrize("cutoff", [200.0, 3000.0, 12000.0])
def test_lowpass_like_jax(cutoff):
    buf, prev = _audio(5), _audio(6, (3,))
    alpha = audio.lowpass_alpha(cutoff)
    assert alpha == jaudio.lowpass_alpha(cutoff)
    want, want_prev = jaudio.lowpass(jnp.asarray(buf), jnp.asarray(prev), alpha)
    got, got_prev = audio.lowpass(torch.from_numpy(buf), torch.from_numpy(prev), alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), **TOL)


@pytest.mark.parametrize("out_len", [1, 100, 441, 480, 960, 1001])
def test_resample_linear_like_jax(out_len):
    buf = _audio(7)
    want = np.asarray(jaudio.resample_linear(jnp.asarray(buf), out_len))
    got = audio.resample_linear(torch.from_numpy(buf), out_len)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(480,), (4, 480), (2, 3, 256)])
def test_analyze_levels_like_jax(shape):
    buf = _audio(8, shape)
    buf[..., 0] = 0.0
    want = jaudio.analyze_levels(jnp.asarray(buf))
    got = audio.analyze_levels(torch.from_numpy(buf))
    assert set(got) == set(want) == {"rms", "peak", "rms_db", "peak_db"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    silent = audio.analyze_levels(torch.zeros(16))
    np.testing.assert_allclose(float(silent["rms_db"]),
                               float(jaudio.analyze_levels(jnp.zeros(16))["rms_db"]), **TOL)
