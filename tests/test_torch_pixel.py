"""The port's plain per-pixel ops and K1's plain path (ops/resize.py) against
the JAX package: the gather resize, the Pallas resize kernel in interpret
mode, the oracle's resize, and luma, keys and quantizers. Tolerance: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import cells as jcells
from asciichat_tpu.ops import pixel as jpixel
from asciichat_tpu.ops.pallas_resize import resize_nn_pallas
from asciichat_tpu.render import oracle
from asciichat_tpu.render import palette as pal
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.ops import pixel as tpixel
from asciichat_tpu_torch.ops import resize

from conftest import synthetic_frame


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RESIZES = [((48, 64), (12, 40)), ((37, 53), (20, 31)), ((16, 16), (40, 80)),
           ((240, 320), (57, 203)), ((64, 96), (17, 41)), ((5, 7), (5, 7))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_oracle_and_jax(src, dst):
    frames = np.stack([synthetic_frame(*src, seed=s) for s in range(2)])
    got = resize.resize_nn(torch.from_numpy(frames), *dst).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], oracle.resize_image(frames[i], dst_w=dst[1], dst_h=dst[0]))
    np.testing.assert_array_equal(
        got, np.asarray(jpixel.resize_nn(jnp.asarray(frames), *dst, "gather")))


@pytest.mark.parametrize("src,dst", [((64, 96), (17, 41)), ((37, 53), (20, 31))])
def test_resize_matches_pallas_kernel_interpret(src, dst):
    frames = np.stack([synthetic_frame(*src, seed=s) for s in range(2)])
    want = np.asarray(resize_nn_pallas(jnp.asarray(frames), *dst, interpret=True))
    got = resize.resize_nn(torch.from_numpy(frames), *dst)
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_cpu_path_launches_no_kernel():
    before = resize.RESIZE_KERNEL.launches
    frames = torch.from_numpy(synthetic_frame(20, 30)[None])
    assert resize.resize_nn(frames, 20, 30) is frames  # src == dst returns as is
    resize.resize_nn(frames, 7, 9)
    assert resize.RESIZE_KERNEL.launches == before


def _edge_frame() -> np.ndarray:
    """Grays, saturated corners and equidistant ANSI-16 ties
    ((64,0,0) lies as near black as dark red: the first colour wins)."""
    px = [(0, 0, 0), (255, 255, 255), (64, 0, 0), (0, 64, 0), (64, 64, 64),
          (160, 160, 160), (96, 96, 0), (128, 128, 128), (1, 2, 3), (255, 0, 0),
          (192, 192, 192), (224, 224, 224), (127, 127, 127), (64, 64, 0),
          (0, 96, 96), (255, 128, 0)]
    return np.array(px, np.uint8).reshape(4, 4, 3)


FRAMES = {
    "random": lambda: np.random.default_rng(3).integers(0, 256, (2, 9, 11, 3),
                                                        dtype=np.uint8),
    "edges": lambda: _edge_frame()[None],
}
OPS = {
    "luminance": (tpixel.luminance, jpixel.luminance),
    "quantize_256": (tpixel.quantize_256, jpixel.quantize_256),
    "quantize_16": (tpixel.quantize_16, jpixel.quantize_16),
}


@pytest.mark.parametrize("frames", list(FRAMES))
@pytest.mark.parametrize("op", list(OPS))
def test_pixel_op_matches_jax(op, frames):
    x = FRAMES[frames]()
    mine, ref = OPS[op]
    got = mine(torch.from_numpy(x))
    want = np.asarray(ref(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("palette", ["standard", "blocks"])
def test_mono_keys_match_jax(palette):
    p = pal.BUILTIN_PALETTES[palette]
    x = FRAMES["random"]()
    got = tpixel.mono_keys(torch.from_numpy(x), tcells.ramp_for_palette(p))
    want = np.asarray(jpixel.mono_keys(jnp.asarray(x), jcells.ramp_for_palette(p)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h", [1, 4, 7])
def test_halfblock_split_matches_jax(h):
    x = np.random.default_rng(h).integers(0, 256, (2, h, 5, 3), dtype=np.uint8)
    got = tpixel.halfblock_split(torch.from_numpy(x))
    want = jpixel.halfblock_split(jnp.asarray(x))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_index_tables_reject_out_of_range_indices():
    with pytest.raises(ValueError):
        resize.IndexTables.from_host(10, 10, np.array([0, 10]), np.array([0]), "cpu")
    with pytest.raises(ValueError):
        resize.IndexTables.from_host(10, 10, np.array([0]), np.array([-1]), "cpu")
    t = resize.resize_tables(1080, 1920, 57, 203, "cpu")
    assert t.sy.dtype == torch.int32 and t.sy.is_contiguous()
    assert t.sy.shape == (57,) and t.sx.shape == (203,)
