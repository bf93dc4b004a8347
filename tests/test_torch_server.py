"""The port's server render tick (models/server.py) against the JAX package:
RenderGroup.step and render_groups records with mixed filters and rainbow,
state carried over by utils/convert.py, the emitted bytes against the
oracle, and the host-side maps and filter words K3 reads. Tolerance: exact
equality."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asciichat_tpu.models import server as jserver
from asciichat_tpu.ops import compositor as jcomp
from asciichat_tpu.render import emitter, oracle
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.models import server as tserver
from asciichat_tpu_torch.ops import cells as tcells
from asciichat_tpu_torch.ops import compositor as tcomp
from asciichat_tpu_torch.ops import filters as tfilt
from asciichat_tpu_torch.ops import pixel as tpixel
from asciichat_tpu_torch.utils import convert

from conftest import synthetic_frame

CPU = torch.device("cpu")
SIZES = [(80, 60), (64, 48), (50, 70)]
FILTERS = ["none", "green", "rainbow", "black", "pink"]
TIME_S = 2.2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stack(sizes=SIZES, seed=0) -> np.ndarray:
    """The server's source stack: each source top-left in a frame padded to
    the largest width and height."""
    hmax = max(h for _, h in sizes)
    wmax = max(w for w, _ in sizes)
    stack = np.zeros((len(sizes), hmax, wmax, 3), np.uint8)
    for i, (w, h) in enumerate(sizes):
        stack[i, :h, :w] = synthetic_frame(h, w, seed=seed + i)
    return stack


CAPS = [
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.HALF_BLOCK),
    TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND),
    TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
]


@pytest.mark.parametrize("caps", CAPS, ids=lambda c: c.renderer_key())
def test_render_group_step_matches_jax(caps):
    stack = _stack()
    jg = jserver.RenderGroup(SIZES, 100, 30, caps, FILTERS)
    tg = tserver.RenderGroup(SIZES, 100, 30, caps, FILTERS, device=CPU)
    tg.load_state(convert.group_arrays(jg))
    assert dataclasses.astuple(tg.render) == dataclasses.astuple(jg.render)
    want = jg.step(jnp.asarray(stack), TIME_S)
    got = tg.step(torch.from_numpy(stack), TIME_S)
    assert sorted(got) == sorted(want)  # jit returns its dicts key-sorted
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == torch.uint8


@pytest.mark.parametrize("time_s", [0.0, 1.1, 3.0, -0.7])
def test_render_group_bytes_match_oracle(time_s):
    """Every receiver's frame, emitted, equals the oracle applied to the
    filtered composite (the per-receiver convert of stream.c:790-854)."""
    caps = CAPS[0]
    stack = _stack(seed=3)
    grp = tserver.RenderGroup(SIZES, 100, 30, caps, FILTERS, device=CPU)
    r = grp.render
    outs = emitter.emit_frames(tcells.records_to_numpy(grp.step(torch.from_numpy(stack), time_s)),
                               r.mode, grp.palette, pad_w=r.pad_w, pad_h=r.pad_h)
    comp = tcomp.composite_reference(stack, tcomp.plan_composite(SIZES, 100, 30))
    for c, name in enumerate(FILTERS):
        want = oracle.ascii_convert_with_capabilities(
            tfilt.apply_color_filter_reference(comp, name, time_s), 100, 60, caps)
        assert outs[c] == want, name


def test_render_compute_matches_jax():
    caps = CAPS[1]
    stack = _stack(seed=5)
    plan = jserver.plan_tick(SIZES, 90, 26, caps)
    arrays = dict(zip(("cidx", "src_y", "src_x", "comp_mask"),
                      jcomp.host_maps(plan.composite)))
    params = tfilt.filter_params(FILTERS, 0.4)
    geo = dict(mode=plan.render.mode, dst_h=plan.render.dst_h_px, dst_w=plan.render.dst_w)
    ramp = tcells.ramp_for_palette(tserver.pal.DEFAULT_PALETTE)
    want = jserver.render_compute(jnp.asarray(stack), jnp.asarray(ramp.numpy()),
                                  *(jnp.asarray(p) for p in params),
                                  *(jnp.asarray(a) for a in arrays.values()), **geo)
    got = tserver.render_compute(torch.from_numpy(stack), ramp,
                                 *(torch.from_numpy(p) for p in params),
                                 *(torch.from_numpy(a) for a in arrays.values()), **geo)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("caps", CAPS[:2] + CAPS[4:5], ids=lambda c: c.renderer_key())
def test_plan_tick_matches_jax(caps):
    sizes = [(800, 600)] * 9
    a = jserver.plan_tick(sizes, 203, 64, caps)
    b = tserver.plan_tick(sizes, 203, 64, caps)
    assert dataclasses.astuple(a.render) == dataclasses.astuple(b.render)
    assert a.num_clients == b.num_clients
    np.testing.assert_array_equal(a.composite.client_idx, b.composite.client_idx)


LAYOUTS = [(SIZES, 100, 30, 60, 100), (SIZES, 100, 30, 31, 57),
           ([(640, 480)] * 4, 60, 20, 40, 60), ([(30, 20)], 40, 12, 24, 40)]


@pytest.mark.parametrize("sizes,term_w,term_h,dst_h,dst_w", LAYOUTS)
def test_composed_maps_equal_composite_then_resize(sizes, term_w, term_h, dst_h, dst_w):
    """K3 reads frames[cidx, sy, sx] through the composed maps (black where
    cidx is -1); that must equal resizing the composite."""
    stack = _stack(sizes, seed=9)
    plan = tcomp.plan_composite(sizes, term_w, term_h)
    maps = tcomp.host_maps(plan)
    k_cidx, k_sy, k_sx = tcomp.compose_maps(*maps, dst_h, dst_w)
    assert k_cidx.dtype == k_sy.dtype == k_sx.dtype == np.int32
    got = stack[np.maximum(k_cidx, 0), k_sy, k_sx]
    got[k_cidx < 0] = 0
    comp = torch.from_numpy(tcomp.composite_reference(stack, plan))
    want = tpixel.resize_nn(comp[None], dst_h, dst_w)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes,term_w,term_h,dst_h,dst_w", LAYOUTS)
def test_pixel_words_equal_composite_then_resize(sizes, term_w, term_h, dst_h, dst_w):
    """K3's one-word map (byte offsets in the stack, -1 for background)
    reads the same pixels as resizing the composite."""
    stack = _stack(sizes, seed=11)
    plan = tcomp.plan_composite(sizes, term_w, term_h)
    words = tcomp.pixel_words(*tcomp.compose_maps(*tcomp.host_maps(plan), dst_h, dst_w),
                              stack.shape)
    assert words.dtype == np.int32 and words.shape == (dst_h, dst_w)
    flat = stack.reshape(-1)
    got = flat[np.maximum(words, 0)[..., None] + np.arange(3)]
    got[words < 0] = 0
    comp = torch.from_numpy(tcomp.composite_reference(stack, plan))
    want = tpixel.resize_nn(comp[None], dst_h, dst_w)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_pixel_words_refuse_a_stack_past_int32():
    k = np.zeros((2, 3), np.int32)
    tcomp.pixel_words(k, k, k, (8, 600, 800, 3))
    with pytest.raises(ValueError, match="int32"):
        tcomp.pixel_words(k, k, k, (2000, 600, 800, 3))


def test_render_groups_match_jax_groups():
    """render_groups on the CPU, three groups of different geometry, mode,
    palette and receivers in one call, each equal to the JAX package's
    RenderGroup.step of that group, tick after tick (the rainbow moves)."""
    stack = _stack(seed=13)
    specs = [(100, 30, CAPS[0], FILTERS, tserver.pal.DEFAULT_PALETTE),
             (61, 21, CAPS[5], ["rainbow"], tserver.pal.DEFAULT_PALETTE),
             (40, 13, CAPS[6], ["cyan", "none", "red"], tserver.pal.BUILTIN_PALETTES["digital"])]
    jgroups = [jserver.RenderGroup(SIZES, w, h, caps, names, palette)
               for w, h, caps, names, palette in specs]
    tgroups = [tserver.RenderGroup(SIZES, w, h, caps, names, palette, device=CPU)
               for w, h, caps, names, palette in specs]
    for time_s in (0.3, 1.9):
        got = tserver.render_groups(torch.from_numpy(stack), tgroups, time_s)
        for jg, rec in zip(jgroups, got):
            want = jg.step(jnp.asarray(stack), time_s)
            assert sorted(rec) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(rec[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert [g.ticks for g in tgroups] == [2, 2, 2]


def test_receiver_words_and_tile_width():
    tint, fg, rb, on = tfilt.filter_params(["none", "black", "rainbow", "pink"], 0.7)
    words = tserver.receiver_words(tint, fg, rb, on)
    assert words.dtype == np.uint8 and words.shape == (4, 4)
    np.testing.assert_array_equal(words[:, :3], tint)
    assert list(words[:, 3]) == [0, tserver.RECV_ENABLED | tserver.RECV_FG_ON_BG,
                                 tserver.RECV_ENABLED | tserver.RECV_RAINBOW,
                                 tserver.RECV_ENABLED]
    with pytest.raises(ValueError, match="0..255"):
        tserver.receiver_words(tint + 300, fg, rb, on)
    for rows, width in ((64, 203), (24, 80), (1, 1024), (512, 7)):
        w = tserver.tile_width(rows, width, 132)
        assert tserver.K3_MIN_TILE_CELLS <= w <= tserver.K3_MAX_TILE_CELLS
    assert tserver.tile_width(64, 203, 132) == 68  # 3 tiles a row: 192 tiles fill 132 SMs


def test_group_maps_bound_the_source_stack():
    grp = tserver.RenderGroup(SIZES, 100, 30, CAPS[0], ["none"], device=CPU)
    m = grp.maps
    assert m.n_src == len(SIZES)
    assert m.min_h <= max(h for _, h in SIZES) and m.min_w <= max(w for w, _ in SIZES)
    live = m.k_cidx >= 0
    assert int(m.k_sy[live].max()) < m.min_h and int(m.k_sx[live].max()) < m.min_w
    assert m.k_cidx.shape == (grp.render.dst_h_px, grp.render.dst_w)
    shape = (m.n_src, m.min_h, m.min_w, 3)
    words = m.words(shape)
    assert m.words(shape) is words  # the last shape's map is kept
    np.testing.assert_array_equal(
        words.numpy(), tcomp.pixel_words(m.k_cidx, m.k_sy, m.k_sx, shape))
    assert m.words((m.n_src + 1, m.min_h, m.min_w + 5, 3)) is not words
    with pytest.raises(ValueError, match="smaller than"):
        m.words((m.n_src, m.min_h - 1, m.min_w, 3))


def test_rainbow_refresh_replaces_only_tint():
    grp = tserver.RenderGroup(SIZES, 100, 30, CAPS[0], ["rainbow", "none"], device=CPU)
    stack = torch.from_numpy(_stack())
    grp.step(stack, 0.1)
    fixed = (grp.fg_on_bg, grp.is_rainbow, grp.filter_on, grp.maps, grp.ramp)
    tint = grp.tint.clone()
    grp.step(stack, 1.9)
    assert all(a is b for a, b in zip(fixed, (grp.fg_on_bg, grp.is_rainbow,
                                              grp.filter_on, grp.maps, grp.ramp)))
    assert not torch.equal(tint, grp.tint)
    np.testing.assert_array_equal(grp.tint[0].numpy(), tfilt.rainbow_color(1.9))
    assert grp.ticks == 2


def test_set_filters_changes_receiver_count():
    grp = tserver.RenderGroup(SIZES, 100, 30, CAPS[2], ["none"], device=CPU)
    stack = torch.from_numpy(_stack())
    assert grp.step(stack)["fg"].shape[0] == 1
    grp.set_filters(["green", "cyan", "rainbow"])
    assert grp.has_rainbow and grp.n_real == 3
    assert grp.step(stack, 0.5)["fg"].shape[0] == 3


def test_convert_rejects_mismatched_dtype():
    with pytest.raises(ValueError, match="tint"):
        convert.to_torch({"tint": np.zeros((2, 3), np.float32)}, CPU)
    t = convert.to_torch({"ramp": np.zeros(64, np.uint8),
                          "cidx": np.zeros((2, 2), np.int32)}, CPU)
    assert t["ramp"].dtype == torch.uint8 and t["cidx"].dtype == torch.int32
