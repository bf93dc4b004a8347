"""Device ANSI emission on the port (ops/emit.py) against the JAX package's
``ops/emit.emit_truecolor_fg`` and the oracle.

The plain version must give the JAX function's whole buffer (zeros past
each length) and lengths on the same numpy inputs, and each frame the
oracle's bytes; the cases of tests/test_device_emit.py run on the port.
The wrapper takes the plain version for CPU tensors and refuses what K6
does not take; K6 itself against the plain version needs the card
(test_torch_kernels.py, marker ``gpu``; its source runs here under
tests/cuda_emu.h, in test_torch_emit_emulated.py). Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asciichat_tpu.ops import emit as jemit
from asciichat_tpu.ops import pixel as jpixel
from asciichat_tpu.render import oracle
from asciichat_tpu.render import palette as pal
from asciichat_tpu_torch.ops import emit, pixel

def _luma(rgb: np.ndarray) -> np.ndarray:
    return np.asarray(jpixel.luminance(jnp.asarray(rgb))).astype(np.uint8)


def _frames() -> dict[str, np.ndarray]:
    """[B, H, W, 3] cases: single- and three-digit components, flat runs,
    1-wide and 1-high frames, a batch of 4."""
    rng = np.random.default_rng(3)
    flat = np.zeros((2, 9, 31, 3), np.uint8)
    flat[:, :, :15] = [7, 200, 13]
    flat[1, 4:] = [0, 0, 0]
    return {
        "single_digits": np.full((1, 4, 6, 3), 9, np.uint8),
        "three_digits": np.full((1, 4, 6, 3), 255, np.uint8),
        "mixed_digits": rng.choice(np.array([0, 7, 10, 99, 100, 255], np.uint8),
                                   (1, 7, 11, 3)),
        "flat_runs": flat,
        "one_wide": rng.integers(0, 256, (2, 6, 1, 3), dtype=np.uint8),
        "one_high": rng.integers(0, 256, (2, 1, 9, 3), dtype=np.uint8),
        "one_cell": rng.integers(0, 256, (1, 1, 1, 3), dtype=np.uint8),
        "batch_of_4": rng.integers(0, 256, (4, 10, 13, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("case", list(_frames()))
def test_plain_equals_the_jax_function(case):
    rgb = _frames()[case]
    b, h, w, _ = rgb.shape
    luma = _luma(rgb)
    tbl = jemit.ascii_glyph_table()
    want, want_len = jemit.emit_truecolor_fg(jnp.asarray(rgb), jnp.asarray(luma),
                                             jnp.asarray(tbl), H=h, W=w)
    got, got_len = emit.emit_truecolor_fg(torch.from_numpy(rgb), torch.from_numpy(luma),
                                          torch.from_numpy(tbl))
    assert got.dtype == torch.uint8 and got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(b):
        assert got.numpy()[i, :got_len[i]].tobytes() == oracle.render_truecolor_fg(rgb[i])


def test_glyph_table_is_the_jax_packages():
    for palette in (pal.BUILTIN_PALETTES["standard"], pal.BUILTIN_PALETTES["minimal"],
                    " .:-=+*#%@"):
        np.testing.assert_array_equal(emit.ascii_glyph_table(palette),
                                      jemit.ascii_glyph_table(palette))


# tests/test_device_emit.py on the port


def _records(rgb):
    luma = pixel.luminance(torch.from_numpy(rgb[None])).to(torch.uint8).numpy()
    return {"rgb": rgb[None], "luma": luma}


def test_device_emit_matches_oracle():
    rng = np.random.default_rng(11)
    cases = []
    for h, w in [(12, 17), (1, 5), (3, 1), (24, 40), (2, 2)]:
        cases.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    flat = np.zeros((9, 31, 3), np.uint8)  # long runs: SGR only at starts
    flat[:, :15] = [7, 200, 13]
    cases.append(flat)
    grad = np.stack(np.broadcast_arrays(
        np.arange(20)[:, None] * 12, np.arange(30)[None, :] * 8, 128),
        -1).astype(np.uint8)
    cases.append(grad)
    cases.append(np.full((4, 6, 3), 9, np.uint8))
    cases.append(np.full((4, 6, 3), 255, np.uint8))
    for rgb in cases:
        got = emit.emit_frames_device(_records(rgb))[0]
        want = oracle.render_truecolor_fg(rgb)
        assert got == want, rgb.shape


def test_device_emit_batched_consistency():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (4, 10, 13, 3), dtype=np.uint8)
    luma = pixel.luminance(torch.from_numpy(rgb)).to(torch.uint8)
    outs = emit.emit_frames_device({"rgb": rgb, "luma": luma})
    for i in range(4):
        assert outs[i] == oracle.render_truecolor_fg(rgb[i])


@pytest.mark.parametrize("palette", ["blocks", "digital"])
def test_device_emit_rejects_utf8_palettes(palette):
    glyphs = pal.BUILTIN_PALETTES[palette]
    assert any(ord(ch) >= 128 for ch in glyphs)
    with pytest.raises(ValueError, match="multi-byte"):
        emit.ascii_glyph_table(glyphs)
    with pytest.raises(ValueError):
        jemit.ascii_glyph_table(glyphs)


def test_wrapper_refuses_what_k6_does_not_take():
    rgb = torch.zeros((1, 2, 3, 3), dtype=torch.uint8)
    tbl = torch.from_numpy(emit.ascii_glyph_table())
    with pytest.raises(ValueError, match="at least one cell"):
        emit.emit_truecolor_fg(torch.zeros((1, 0, 3, 3), dtype=torch.uint8),
                               torch.zeros((1, 0, 3), dtype=torch.uint8), tbl)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        emit.emit_truecolor_fg(rgb.to("meta"), torch.zeros((1, 2, 3), dtype=torch.uint8), tbl)
    assert emit.EMIT_KERNEL.entry == "ac_device_emit"  # not the host emitter's ac_emit_truecolor_fg
