"""The row ingest's tables and rule on the CPU (ops/ingest.py, ops/cells.row_tables).

Pinned host frames go to the card as the source rows the geometry samples
alone, and K1 and K2 gather from that compact batch through tables whose row
indices point into it. Here the compact batch is ``frames[:, rows]`` and the
gathers are NumPy's, held byte for byte against the plain render of the full
frames (``records_for_mode(pixel.resize_nn(...))``) in all 10 modes; the row
copy itself and the kernels run under the emulated CUDA grid in
``test_torch_cells_emulated.py`` (design ``rows``) and on the card in
``test_torch_fuzz_gpu.py``."""

import numpy as np
import pytest
import torch

from asciichat_tpu_torch.ops import cells, ingest, pixel
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import AsciiRenderer
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.utils import trace
from asciichat_tpu_torch.utils.aspect import resize_indices

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)  # a device name only: nothing here touches a card
# name: (batch, src_h, src_w, dst_h px, dst_w, distinct rows where the row path engages)
SOURCES = {
    "1080p_truecolor": (2, 1080, 1920, 57, 203, 57),
    "1080p_halfblock": (2, 1080, 1920, 114, 203, 114),
    "webcam_640x480": (3, 480, 640, 64, 171, 64),
    "odd_61x83": (2, 61, 83, 21, 37, 21),
    "odd_rows_of_half": (1, 59, 45, 29, 17, 29),
    "near_one_to_one": (1, 100, 90, 60, 50, None),
    "upscale_16x16": (2, 16, 16, 40, 80, None),
    "one_to_one": (2, 37, 53, 37, 53, None),
}


def frames_for(b: int, h: int, w: int) -> torch.Tensor:
    f = np.random.default_rng(h * w + b).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    f[0, :2] = 0  # black rows for the transparent flag
    return torch.from_numpy(f)


def gather(frames: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """K1's gather in NumPy: out[b, y, x] = frames[b, sy[y], sx[x]]."""
    f = frames.numpy()
    return torch.from_numpy(f[:, sy.numpy()][:, :, sx.numpy()].copy())


@pytest.mark.parametrize("mode", cells.MODES)
@pytest.mark.parametrize("source", list(SOURCES))
def test_rows_and_remapped_tables_give_the_full_frames_records(source, mode):
    b, h, w, dh, dw, engaged = SOURCES[source]
    frames = frames_for(b, h, w)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    want = cells.records_for_mode(pixel.resize_nn(frames, dh, dw), mode, ramp)

    rows, compact = cells.row_tables(h, w, dh, dw, CPU)
    assert np.array_equal(rows, np.unique(resize_indices(h, dh)))
    assert (compact.resize.src_h, compact.resize.src_w) == (len(rows), w)
    sampled = ingest.copy_rows(frames, rows, CPU)
    assert torch.equal(sampled, frames[:, torch.from_numpy(rows.astype(np.int64))])
    if cells.mode_family(mode) == cells.FAM_HB_RGB:  # K1 twice, as render_cells launches it
        got = {"top": gather(sampled, compact.top.sy, compact.top.sx),
               "bot": gather(sampled, compact.bot.sy, compact.bot.sx)}
    else:  # K2: the resize gather, then the mode's records
        got = cells.records_for_mode(
            gather(sampled, compact.resize.sy, compact.resize.sx), mode, ramp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k

    # the row path engages where the geometry samples at most half the rows
    tables = cells.cell_tables(h, w, dh, dw, CPU)
    assert (tables.rows is not None) == (len(rows) <= h // 2) == (engaged is not None)
    if engaged is not None:
        assert len(tables.rows) == engaged
        assert np.array_equal(tables.rows, rows)
        for name in ("resize", "top", "bot"):
            assert torch.equal(getattr(tables.compact, name).sy, getattr(compact, name).sy)
    else:
        assert tables.compact is None


def test_row_layout_takes_rows_it_can_address():
    """The row copy takes uint8 [B,H,W,3] host frames whose rows are
    contiguous and whose frames lie a whole number of rows apart."""
    f = torch.zeros((4, 30, 20, 3), dtype=torch.uint8)
    line, frame = 20 * 3, 30 * 20 * 3
    assert ingest.row_layout(f) == (frame, line)
    assert ingest.row_layout(f[::2]) == (2 * frame, line)  # every other frame
    assert ingest.row_layout(f[:, 5:25]) == (frame, line)  # a band of rows
    assert ingest.row_layout(f[:, ::3]) == (frame, 3 * line)  # every third row
    assert ingest.row_layout(f[:1]) == (frame, line)
    assert ingest.row_layout(f[:, :, 2:18]) == (frame, line)  # a crop of columns
    assert ingest.row_layout(f[:, :1]) == (frame, line)  # one row a frame: packed rows
    assert ingest.row_layout(f[:, :, :1]) == (frame, line)  # one column
    wide = torch.zeros((2, 30 * 20 * 3 + 7), dtype=torch.uint8)
    assert ingest.row_layout(wide[:, :frame].view(2, 30, 20, 3)) is None  # 7 bytes between frames
    assert ingest.row_layout(f.permute(0, 2, 1, 3)) is None  # columns as rows
    assert ingest.row_layout(f[:, :, ::2]) is None  # every other pixel
    assert ingest.row_layout(f.float()) is None
    assert ingest.row_layout(f[0]) is None
    assert ingest.row_layout(f[:0]) is None
    assert ingest.row_layout(f.numpy()) is None
    assert ingest.row_layout(torch.zeros((2, 4, 4, 4), dtype=torch.uint8)) is None


def test_takes_rows_only_for_pinned_frames_bound_for_a_card():
    """Numpy frames and pageable tensors go whole; so do frames for a CPU
    renderer and geometries with no row form (``rows`` None)."""
    rows, _ = cells.row_tables(1080, 1920, 57, 203, CPU)
    pageable = torch.zeros((2, 1080, 1920, 3), dtype=torch.uint8)
    assert not pageable.is_pinned()
    assert not ingest.takes_rows(pageable, CUDA, rows)
    assert not ingest.takes_rows(pageable.numpy(), CUDA, rows)
    assert not ingest.takes_rows(pageable, CPU, rows)
    assert not ingest.takes_rows(pageable, CUDA, None)


def test_copy_rows_on_a_card_refuses_frames_it_cannot_take():
    """copy_rows checks its frames before it touches a card."""
    rows = np.array([0, 2], np.int32)
    with pytest.raises(ValueError, match="pinned"):
        ingest.copy_rows(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), rows, CUDA)


@pytest.mark.parametrize("caps", [TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
                                  TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)],
                         ids=["truecolor", "halfblock"])
def test_cpu_renderer_counts_whole_batches(caps):
    """A CPU renderer takes every batch whole and counts it so, with the
    batch's bytes; it never counts a row batch."""
    frames = frames_for(2, 96, 128).numpy()
    before = trace.PROCESS.counters()
    AsciiRenderer(device=CPU).convert_batch(frames, 40, 12, caps)
    after = trace.PROCESS.counters()

    def delta(key):
        return after.get(key, 0) - before.get(key, 0)
    assert delta("render.ingest.ingest_whole_batches") == 1
    assert delta("render.ingest.ingest_row_batches") == 0
    assert delta("render.ingest.ingest_rows") == 0
    assert delta("render.ingest.bytes") == frames.nbytes
