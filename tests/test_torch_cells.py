"""The port's cell records (ops/cells.py) against the JAX package's, for all
10 modes: the plain records, the full render_cells path on the CPU, and the
host-side pieces the CUDA path uses (gather tables, record allocation,
pinned fetch). Tolerance: exact equality of every uint8 record."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.ops import cells as jcells
from asciichat_tpu.ops import pixel as jpixel
from asciichat_tpu.render import palette as pal
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.ops import pixel as tpixel


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_records_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)  # jit returns its dicts key-sorted
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_modes_match_jax():
    assert tcells.MODES == jcells.MODES
    assert set(tcells.MODE_FAMILY) == set(jcells.MODES)


@pytest.mark.parametrize("shape", [(2, 21, 17), (3, 20, 16), (1, 1, 5)])
@pytest.mark.parametrize("mode", jcells.MODES)
def test_records_for_mode_matches_jax(mode, shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    x[0, 0, :2] = 0  # an all-black pixel pair for the transparent flag
    got = tcells.records_for_mode(torch.from_numpy(x), mode,
                                  tcells.ramp_for_palette(pal.DEFAULT_PALETTE))
    want = jcells.records_for_mode(jnp.asarray(x), mode,
                                   jcells.ramp_for_palette(pal.DEFAULT_PALETTE))
    _assert_records_equal(got, want)


@pytest.mark.parametrize("dst_h", [21, 22])
@pytest.mark.parametrize("mode", jcells.MODES)
def test_render_cells_matches_jax(mode, dst_h):
    x = np.random.default_rng(7).integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    palette = pal.BUILTIN_PALETTES["blocks"]
    got = tcells.render_cells(torch.from_numpy(x), tcells.ramp_for_palette(palette),
                              dst_h=dst_h, dst_w=31, mode=mode)
    want = jcells.render_cells(jnp.asarray(x), jcells.ramp_for_palette(palette),
                               dst_h=dst_h, dst_w=31, mode=mode)
    _assert_records_equal(got, want)


@pytest.mark.parametrize("mode", jcells.MODES)
def test_allocated_records_match_plain_schema(mode):
    """The CUDA path's outputs (allocate_records) have exactly the keys,
    dtypes and shapes of the plain records."""
    x = torch.zeros((2, 9, 6, 3), dtype=torch.uint8)
    plain = tcells.records_for_mode(x, mode, tcells.ramp_for_palette(pal.DEFAULT_PALETTE))
    alloc = tcells.allocate_records(tcells.mode_family(mode), 2, 9, 6, torch.device("cpu"))
    assert list(alloc) == list(plain)
    for k in plain:
        assert alloc[k].shape == plain[k].shape and alloc[k].dtype == plain[k].dtype


@pytest.mark.parametrize("dst_h", [1, 6, 7])
def test_halfblock_gather_tables(dst_h):
    """The CUDA path renders the half-block RGB modes as two K1 gathers with
    the tables of cell_tables: gathering with them equals halfblock_split of
    the resized frames."""
    x = np.random.default_rng(dst_h).integers(0, 256, (2, 30, 40, 3), dtype=np.uint8)
    t = tcells.cell_tables(30, 40, dst_h, 11, torch.device("cpu"))
    frames = torch.from_numpy(x)

    def gather(tables):
        return frames[:, tables.sy.long()][:, :, tables.sx.long()]

    top, bot = jpixel.halfblock_split(jpixel.resize_nn(jnp.asarray(x), dst_h, 11, "gather"))
    np.testing.assert_array_equal(gather(t.top).numpy(), np.asarray(top))
    np.testing.assert_array_equal(gather(t.bot).numpy(), np.asarray(bot))
    np.testing.assert_array_equal(gather(t.resize).numpy(),
                                  tpixel.resize_nn(frames, dst_h, 11).numpy())


def test_records_to_numpy_is_contiguous():
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 6, 8, 3),
                                                           dtype=np.uint8))
    strided = {"rgb": x[:, ::2], "luma": x[..., 0].transpose(1, 2)}
    host = tcells.records_to_numpy(strided)
    for k, v in host.items():
        assert v.flags.c_contiguous
        np.testing.assert_array_equal(v, strided[k].numpy())


def test_unknown_mode_raises():
    x = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    ramp = tcells.ramp_for_palette(pal.DEFAULT_PALETTE)
    with pytest.raises(ValueError):
        tcells.records_for_mode(x, "sixel", ramp)
    with pytest.raises(ValueError):
        tcells.render_cells(x, ramp, dst_h=2, dst_w=2, mode="sixel")
