"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel-vs-plain tests need an NVIDIA card (marker ``gpu``) and skip
where ``torch.cuda.is_available()`` is false; on the card they run with
``python -m pytest tests/test_torch_kernels.py -m gpu``, and
``chip_smoke.py`` runs the same comparisons at the main path's full sizes.
The wrappers' checks and the CPU dispatch run everywhere; on the card also
``runtime/device_stream.py``'s stager and pipeline across their streams.
Tolerance: exact for K1-K3 (uint8 records) and K6 (ANSI bytes, lengths); K4's float32 mixes are held to rtol=2e-4,
atol=2e-5, the bound tests/test_audio.py holds the JAX mixer to, and so are
K5's output and weights (its echo estimates come through the blocked
look-ahead's correction form and its dot products sum in another order; the
far tail, hangover and frozen fraction exactly, and without the AEC the whole
chain bit for bit).
"""

import numpy as np
import pytest
import torch

from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.models import server
from asciichat_tpu_torch.ops import audio, cells, emit, pixel, resize
from asciichat_tpu_torch.runtime import kernel_build
from asciichat_tpu_torch.runtime.device import check_tensor, default_device, require_cuda

from test_torch_capture_emulated import GATE_PEAKS, gate_frames, scenario


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return require_cuda()


def _frames(b, h, w, seed, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [((48, 64), (12, 40)), ((37, 53), (20, 31)),
                                     ((16, 16), (40, 80)), ((240, 320), (57, 203))])
def test_resize_kernel_matches_plain(cuda, src, dst):
    f = _frames(3, *src, seed=1, device=cuda)
    before = resize.RESIZE_KERNEL.launches
    got = resize.resize_nn(f, *dst)
    assert resize.RESIZE_KERNEL.launches == before + 1
    assert torch.equal(got, pixel.resize_nn(f, *dst))


@pytest.mark.gpu
@pytest.mark.parametrize("dst_h", [20, 21])
@pytest.mark.parametrize("mode", cells.MODES)
def test_render_cells_kernel_matches_plain(cuda, mode, dst_h):
    f = _frames(2, 61, 83, seed=2, device=cuda)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    got = cells.render_cells(f, ramp, dst_h=dst_h, dst_w=37, mode=mode)
    want = cells.records_for_mode(pixel.resize_nn(f, dst_h, 37), mode, ramp)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("color", [ColorLevel.TRUECOLOR, ColorLevel.COLOR_16])
@pytest.mark.parametrize("render_mode", [RenderMode.FOREGROUND, RenderMode.HALF_BLOCK])
def test_render_group_kernel_matches_plain(cuda, color, render_mode):
    sizes = [(80, 60), (64, 48), (50, 70)]
    stack = _frames(3, 70, 80, seed=3, device=cuda)
    names = ["none", "green", "rainbow", "black"]
    grp = server.RenderGroup(sizes, 100, 30, TerminalCapabilities(color, render_mode),
                             names, device=cuda)
    got = grp.step(stack, time_s=1.7)
    want = _plain(grp, stack)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _plain(grp: server.RenderGroup, stack: torch.Tensor) -> cells.RecordDict:
    """The plain render of ``grp`` on the stack's device, with the group's
    host filter vectors as they stand."""
    m, r = grp.maps, grp.render
    params = (t.to(stack.device) for t in (grp.tint, grp.fg_on_bg, grp.is_rainbow,
                                           grp.filter_on))
    return server.render_compute(stack, grp.ramp, *params, m.cidx, m.src_y, m.src_x,
                                 m.comp_mask, mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)


def _groups(device, spec, mesh=None) -> list[server.RenderGroup]:
    sizes = [(80, 60), (64, 48), (50, 70)]
    return [server.RenderGroup(sizes, w, h, TerminalCapabilities(color, mode), names,
                               palette=palette, device=device, mesh=mesh)
            for w, h, color, mode, names, palette in spec]


THREE = [(100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK,
          ["none", "green", "rainbow", "black", "pink"], pal.DEFAULT_PALETTE),
         (61, 21, ColorLevel.COLOR_256, RenderMode.FOREGROUND, ["rainbow"],
          pal.DEFAULT_PALETTE),
         (40, 13, ColorLevel.NONE, RenderMode.FOREGROUND,
          ["cyan", "none", "red"], pal.BUILTIN_PALETTES["digital"])]


@pytest.mark.gpu
def test_render_groups_one_launch_matches_plain(cuda):
    """Three groups of different geometry, family and receiver count in one
    K3 launch, each bit-exact against the plain version."""
    stack = _frames(3, 70, 80, seed=5, device=cuda)
    groups = _groups(cuda, THREE)
    arena = server.RecordArena(cuda)
    before = server.RENDER_GROUP_KERNEL.launches
    got = server.render_groups(stack, groups, 2.9, arena)
    assert server.RENDER_GROUP_KERNEL.launches == before + 1
    for g, rec in zip(groups, got):
        want = _plain(g, stack)
        assert list(rec) == list(want)
        for k in want:
            assert torch.equal(rec[k], want[k]), (g.render.mode, k)
    host = arena.fetch(got)
    for rec, h in zip(got, host):
        for k in rec:
            assert np.array_equal(h[k], rec[k].cpu().numpy()), k


@pytest.mark.gpu
@pytest.mark.parametrize("clients, space", [(2, 1), (4, 1), (4, 2), (1, 3)])
def test_render_groups_sharded_on_one_card_matches_plain(cuda, clients, space):
    """A forced mesh on the card (parallel/mesh.py): one K3 launch per
    shard with a part, each shard's descriptors from its first pixel row
    into a record buffer of its own; the gathered records equal the plain
    render, over two ticks of a moving rainbow."""
    from asciichat_tpu_torch.parallel import mesh as meshlib

    stack = _frames(3, 70, 80, seed=9, device=cuda)
    mesh = meshlib.make_mesh(clients * space, space, [cuda] * (clients * space))
    groups = _groups(cuda, THREE, mesh)
    arena = server.MeshArena(mesh)
    shards = len({shard.index for g in groups for shard, _ in g.shard_jobs})
    for time_s in (0.4, 2.0):
        before = server.RENDER_GROUP_KERNEL.launches
        hosts = arena.fetch(server.render_groups(stack, groups, time_s, arena))
        assert server.RENDER_GROUP_KERNEL.launches == before + shards
        for g, host in zip(groups, hosts):
            want = _plain(g, stack)
            for k in want:
                assert np.array_equal(host[k], want[k].cpu().numpy()), (time_s, g.render.mode, k)


@pytest.mark.gpu
def test_render_groups_rainbow_tint_changes_between_ticks(cuda):
    """The rainbow tint changes on the host from tick to tick, with no
    upload, and each tick's records follow it."""
    stack = _frames(3, 70, 80, seed=6, device=cuda)
    groups = _groups(cuda, THREE[:2])
    arena = server.RecordArena(cuda)
    seen = []
    for time_s in (0.2, 1.4, 2.6):
        got = server.render_groups(stack, groups, time_s, arena)
        for g, rec in zip(groups, got):
            np.testing.assert_array_equal(g.tint[g.is_rainbow].numpy()[0],
                                          server.filters.rainbow_color(time_s))
            want = _plain(g, stack)
            for k in want:
                assert torch.equal(rec[k], want[k]), (time_s, k)
        seen.append(got[1]["color"].clone())
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])


@pytest.mark.gpu
def test_record_arena_reused_and_regrown(cuda):
    """The arena keeps its buffer while the groups are unchanged, grows for
    a larger set, and serves a smaller set from the grown buffer."""
    stack = _frames(3, 70, 80, seed=7, device=cuda)
    three = _groups(cuda, THREE)
    arena = server.RecordArena(cuda)
    first = server.render_groups(stack, three[1:], 0.5, arena)
    assert arena._host is None  # the pinned buffer waits for the first fetch
    ptr = first[0]["color"].data_ptr()
    again = server.render_groups(stack, three[1:], 0.5, arena)
    assert again is first and again[0]["color"].data_ptr() == ptr
    grown = server.render_groups(stack, three, 0.5, arena)
    for g, rec in zip(three, grown):
        want = _plain(g, stack)
        for k in want:
            assert torch.equal(rec[k], want[k]), k
    buffer = grown[0]["top"].untyped_storage().data_ptr()
    small = server.render_groups(stack, three[2:], 0.5, arena)
    assert small[0]["key"].untyped_storage().data_ptr() == buffer
    assert torch.equal(small[0]["key"], _plain(three[2], stack)["key"])
    host = arena.fetch(small)
    assert np.array_equal(host[0]["key"], small[0]["key"].cpu().numpy())
    with pytest.raises(ValueError, match="last layout"):
        arena.fetch(grown)


@pytest.mark.gpu
def test_render_groups_past_one_descriptor_and_one_launch(cuda):
    """20 receivers take two descriptors; 18 groups take two launches."""
    stack = _frames(3, 70, 80, seed=8, device=cuda)
    names = (server.filters.FILTER_NAMES * 2)[:20]
    wide = _groups(cuda, [(50, 16, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, names,
                           pal.DEFAULT_PALETTE)])
    kinds = [(c, m) for c in (ColorLevel.NONE, ColorLevel.COLOR_16, ColorLevel.COLOR_256,
                              ColorLevel.TRUECOLOR)
             for m in (RenderMode.FOREGROUND, RenderMode.HALF_BLOCK)]
    many = _groups(cuda, [(30 + 2 * i, 10 + i % 3, *kinds[i % len(kinds)],
                           ["green", "rainbow"][: 1 + i % 2], pal.DEFAULT_PALETTE)
                          for i in range(18)])
    for groups, launches in ((wide, 1), (many, 2)):
        before = server.RENDER_GROUP_KERNEL.launches
        got = server.render_groups(stack, groups, 1.1, server.RecordArena(cuda))
        assert server.RENDER_GROUP_KERNEL.launches == before + launches
        for g, rec in zip(groups, got):
            want = _plain(g, stack)
            for k in want:
                assert torch.equal(rec[k], want[k]), (g.render.mode, k)


@pytest.mark.gpu
def test_render_group_and_tick_compute_from_arrays_match_plain(cuda):
    """The array-level render_group and tick_compute launch K3 (and K4) on
    the card, each into records of its own, and match the plain versions."""
    sizes = [(80, 60), (64, 48), (50, 70)]
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
    tt = server.ServerTick(server.plan_tick(sizes, 100, 30, caps),
                           client_filters=["none", "green", "rainbow"], device=cuda)
    stack = _frames(3, 70, 80, seed=9, device=cuda)
    rng = np.random.default_rng(9)
    sound = torch.from_numpy((rng.standard_normal((3, 480)) * 0.1).astype(np.float32)).to(cuda)
    active = torch.ones(3, dtype=torch.bool, device=cuda)
    r = tt.plan.render
    geo = dict(mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)
    before = (server.RENDER_GROUP_KERNEL.launches, audio.MIXER_KERNEL.launches)
    bare = server.render_group(stack, *tt.consts, **geo)
    records, mixes, _ = server.tick_compute(stack, sound, active, tt.mixer_state, *tt.consts,
                                            **geo)
    assert (server.RENDER_GROUP_KERNEL.launches,
            audio.MIXER_KERNEL.launches) == (before[0] + 2, before[1] + 1)
    assert bare["top"].data_ptr() != records["top"].data_ptr()
    want = _plain(tt.group, stack)
    for k in want:
        assert torch.equal(bare[k], want[k]) and torch.equal(records[k], want[k]), k
    want_mix, _ = audio.mixer_process_reference(sound, active, tt.mixer_state)
    torch.testing.assert_close(mixes, want_mix, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("s,n", [(1, 480), (2, 256), (9, 480), (9, 1000), (32, 480)])
def test_mixer_kernel_matches_plain(cuda, s, n, exclude_self):
    """20 ticks with the state carried, sources dropping out and one tick
    with no active source (silence, state untouched)."""
    rng = np.random.default_rng(s * n)
    c = s if exclude_self else 1
    k_state = audio.MixerState.init(s, c, cuda).astuple()
    p_state = k_state
    for tick in range(20):
        level = rng.choice([0.0, 0.01, 0.1, 0.5, 1.5], (s, 1))
        x = torch.from_numpy((rng.standard_normal((s, n)) * level).astype(np.float32)).to(cuda)
        act = torch.from_numpy(rng.random(s) < 0.8).to(cuda)
        if tick == 7:
            act[:] = False
        before = audio.MIXER_KERNEL.launches
        got, new_k = audio.mixer_process(x, act, k_state, exclude_self=exclude_self)
        assert audio.MIXER_KERNEL.launches == before + 1
        want, p_state = audio.mixer_process_reference(x, act, p_state,
                                                      exclude_self=exclude_self)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5, msg=f"tick {tick}")
        for a, b in zip(new_k, p_state):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        if tick == 7:
            assert torch.count_nonzero(got) == 0
            assert all(torch.equal(a, b) for a, b in zip(new_k, k_state))
        k_state = new_k


@pytest.mark.gpu
def test_mixer_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((33, 480), device=cuda)
    with pytest.raises(ValueError, match="1 to 32"):
        audio.mixer_process(x, torch.ones(33, dtype=torch.bool, device=cuda),
                            audio.MixerState.init(33, 33, cuda).astuple())
    state = audio.MixerState.init(2, 2, cuda).astuple()
    with pytest.raises(ValueError, match="active"):
        audio.mixer_process(x[:2], torch.ones(2, device=cuda), state)
    with pytest.raises(ValueError, match="comp_envelope"):
        audio.mixer_process(x[:2], torch.ones(2, dtype=torch.bool, device=cuda), state,
                            exclude_self=False)


def _chain_state(taps: int, device) -> tuple:
    z = torch.zeros((), device=device)
    return (torch.zeros(taps, device=device), torch.zeros(taps, device=device),
            torch.zeros((), dtype=torch.int32, device=device), z, z, z,
            torch.zeros((), dtype=torch.bool, device=device))


def _chain_frames(state, mic, far, use_aec: bool, taps: int):
    """capture_chain over the frames with the state carried and divergence
    control between frames -> [(out, stats, state)] per frame."""
    args = dict(use_aec=use_aec, taps=taps, mu=0.5, geigel_t=0.5, hangover=1440,
                gate_threshold=0.01)
    frames = []
    for m, f in zip(mic, far):
        out, *state, stats = audio.capture_chain(m, f, *state, audio.highpass_alpha(100.0),
                                                 **args)
        if float(stats[1]) > 2.0 * float(stats[2]) + 1e-9:
            state[0] = state[0] * 0.5
        frames.append((out, stats, tuple(state)))
    return frames


@pytest.mark.gpu
@pytest.mark.parametrize("taps,n", [(256, 480), (256, 100), (64, 1), (100, 960), (1024, 480),
                                    (32, 33), (1024, 3072)])
def test_capture_kernel_matches_plain(cuda, taps, n):
    """K5 against the plain chain over 12 frames of echo, a flipped echo
    path, double talk and silence, one launch a frame; across a block
    boundary of the look-ahead, and at the largest frame and filter (whose
    shared memory passes 48 KB)."""
    mic, far = (torch.from_numpy(a) for a in scenario(taps + n, 12, n))
    before = audio.CAPTURE_KERNEL.launches
    got = _chain_frames(_chain_state(taps, cuda), mic.to(cuda), far.to(cuda), True, taps)
    assert audio.CAPTURE_KERNEL.launches == before + 12
    want = _chain_frames(_chain_state(taps, "cpu"), mic, far, True, taps)
    for k, ((go, gs, gst), (wo, ws, wst)) in enumerate(zip(got, want)):
        torch.testing.assert_close(go.cpu(), wo, rtol=2e-4, atol=2e-5, msg=f"frame {k}")
        torch.testing.assert_close(gst[0].cpu(), wst[0], rtol=2e-4, atol=2e-5)
        assert torch.equal(gst[1].cpu(), wst[1]) and int(gst[2]) == int(wst[2]), k
        assert bool(gst[6]) == bool(wst[6]) and float(gs[0]) == float(ws[0]), k


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 100, 480, 960])
def test_capture_kernel_without_aec_bit_exact(cuda, n):
    mic, far = (torch.from_numpy(a) for a in scenario(n, 10, n))
    got = _chain_frames(_chain_state(0, cuda), mic.to(cuda), far.to(cuda), False, 1)
    want = _chain_frames(_chain_state(0, "cpu"), mic, far, False, 1)
    for k, ((go, _, gst), (wo, _, wst)) in enumerate(zip(got, want)):
        assert torch.equal(go.cpu(), wo), f"frame {k}"
        assert all(torch.equal(a.cpu(), b) for a, b in zip(gst[3:], wst[3:])), k


@pytest.mark.gpu
@pytest.mark.parametrize("hysteresis", [0.9, 1.5])
def test_noise_gate_kernel_hysteresis(cuda, hysteresis):
    """K5's gate alone against the plain gate, bit for bit, over peaks below,
    between and above the two thresholds (tests/test_torch_capture_emulated.py
    test_gate_hysteresis)."""
    lengths = [99 + k % 2 for k in range(len(GATE_PEAKS))]
    genv, gopen = torch.zeros((), device=cuda), torch.zeros((), dtype=torch.bool, device=cuda)
    wenv, wopen = torch.tensor(0.0), torch.tensor(False)
    for k, frame in enumerate(gate_frames(13, GATE_PEAKS, lengths)):
        x = torch.from_numpy(frame)
        got, genv, gopen = audio.noise_gate(x.to(cuda), genv, gopen, hysteresis=hysteresis)
        want, wenv, wopen = audio.noise_gate(x, wenv, wopen, hysteresis=hysteresis)
        assert torch.equal(got.cpu(), want), f"frame {k}"
        assert torch.equal(genv.cpu(), wenv) and bool(gopen) == bool(wopen), k


@pytest.mark.gpu
def test_capture_pipeline_on_the_card(cuda):
    """ClientAudioPipeline on the card (one launch a frame, the state in
    place) against the same pipeline on the CPU."""
    mic, far = scenario(3, 16, 480)
    card = audio.ClientAudioPipeline(device=cuda)
    host = audio.ClientAudioPipeline(device="cpu")
    before = audio.CAPTURE_KERNEL.launches
    for k in range(len(mic)):
        for p in (card, host):
            p.add_far(far[k][:240] if k == 2 else far[k])
        got, want = card.process(mic[k]), host.process(mic[k])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=f"frame {k}")
        assert int(card.aec.hang) == int(host.aec.hang)
        assert card.aec.double_talk_frac == host.aec.double_talk_frac
        assert card.aec.divergence_resets == host.aec.divergence_resets
    assert audio.CAPTURE_KERNEL.launches == before + len(mic)
    assert card.aec.divergence_resets >= 1


@pytest.mark.gpu
def test_capture_kernel_rejects_what_it_does_not_take(cuda):
    state = _chain_state(256, cuda)
    consts = audio.capture_consts(480)
    x = torch.zeros(audio.MAX_CAPTURE_SAMPLES + 1, device=cuda)
    with pytest.raises(ValueError, match=f"1 to {audio.MAX_CAPTURE_SAMPLES}"):
        audio.capture_launch(audio.STAGE_GATE, x, None, state, consts)
    with pytest.raises(ValueError, match="taps"):
        audio.capture_launch(audio.STAGE_AEC, x[:480], x[:480], state, consts, taps=2048)
    with pytest.raises(ValueError, match="weights"):
        audio.capture_launch(audio.STAGE_AEC, x[:480], x[:480], state, consts, taps=128)
    with pytest.raises(ValueError, match="gate_open"):
        audio.capture_launch(audio.STAGE_GATE, x[:480], None,
                             state[:6] + (state[6].to(torch.uint8),), consts)


def test_check_tensor_rejects_what_kernels_do_not_take():
    cpu = torch.device("cpu")
    ok = torch.zeros((2, 4, 5, 3), dtype=torch.uint8)
    check_tensor(ok, "frames", torch.uint8, (None, 4, 5, 3), cpu)
    bad = [
        (ok.to(torch.int32), "dtype"),
        (ok[:, :, :4], "shape"),
        (ok.transpose(1, 2), "shape"),
        (ok.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), "contiguous"),
        (ok.numpy(), "torch.Tensor"),
    ]
    for t, why in bad:
        with pytest.raises(ValueError, match=why):
            check_tensor(t, "frames", torch.uint8, (None, 4, 5, 3), cpu)
    with pytest.raises(ValueError, match="expected cuda"):
        check_tensor(ok, "frames", torch.uint8, (None, 4, 5, 3), torch.device("cuda", 0))


def test_cpu_tensors_take_the_plain_path():
    before = {k.name: k.launches for k in (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL,
                                           server.RENDER_GROUP_KERNEL)}
    f = _frames(2, 30, 40, seed=4, device="cpu")
    resize.resize_nn(f, 11, 13)
    cells.render_cells(f, cells.ramp_for_palette(pal.DEFAULT_PALETTE), dst_h=11,
                       dst_w=13, mode="halfblock_16")
    grp = server.RenderGroup([(40, 30)], 30, 10, TerminalCapabilities(), ["green"],
                             device="cpu")
    grp.step(f[:1])
    after = {k.name: k.launches for k in (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL,
                                          server.RENDER_GROUP_KERNEL)}
    assert after == before


def test_kernel_entry_points_are_declared():
    with pytest.raises(ValueError, match="unknown entry point"):
        kernel_build.Kernel("x", "ac_missing", "csrc/x.cu", "x.py:1")
    sources = {p.name for p in kernel_build.CSRC_DIR.glob("*.cu")}
    assert sources == {"resize.cu", "cell_records.cu", "render_group.cu", "mixer.cu",
                       "capture.cu", "emit.cu"}
    for k in (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL, server.RENDER_GROUP_KERNEL,
              audio.MIXER_KERNEL, audio.CAPTURE_KERNEL, emit.EMIT_KERNEL):
        assert (kernel_build.CSRC_DIR.parent.parent / k.source).is_file()
        text = (kernel_build.CSRC_DIR.parent.parent / k.source).read_text()
        assert f'extern "C" int {k.entry}(' in text


def test_default_device_carries_the_card_index(monkeypatch):
    """torch.cuda.set_device and the server's per-thread binding need an
    indexed device: "cuda" resolves to the current card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cuda")
    assert default_device() == torch.device("cuda", 0)
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cuda:3")
    assert default_device() == torch.device("cuda", 3)
    monkeypatch.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
    assert default_device() == torch.device("cpu")


def test_require_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 10, 13), (2, 1, 9), (2, 6, 1), (3, 57, 203)])
def test_k6_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    rgb = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    rgb[0, :, : shape[2] // 2] = 0  # runs that cross row ends
    luma = pixel.luminance(rgb).to(torch.uint8)
    tbl = torch.from_numpy(emit.ascii_glyph_table())
    before = emit.EMIT_KERNEL.launches
    got, got_len = emit.emit_truecolor_fg(rgb, luma, tbl)
    assert emit.EMIT_KERNEL.launches == before + 1
    want, want_len = emit.emit_truecolor_fg_reference(rgb, luma, tbl)
    assert torch.equal(got_len, want_len)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1, 5), (57, 203), (300, 7)])
@pytest.mark.parametrize("batch", [1, 9, 128])
def test_k6_batches_match_plain(cuda, batch, hw):
    """K6 at the mirror's batch (1), the server's (9) and the bench's (128),
    on frames of one tile, 12 tiles with edges mid-row, and 3 tiles of
    7-cell rows: colours in runs of 1-4 cells, so that some cells open and
    some do not, also across tile edges. Bit for bit, the whole buffer."""
    rng = np.random.default_rng(batch * 1000 + hw[0])
    n = hw[0] * hw[1]
    fresh = rng.random((batch, n)) < 0.5
    fresh[:, 0] = True
    idx = np.maximum.accumulate(np.where(fresh, np.arange(n), 0), axis=1)
    colours = rng.integers(0, 256, (batch, n, 3), dtype=np.uint8)
    runs = np.take_along_axis(colours, idx[..., None], axis=1).reshape(batch, *hw, 3)
    rgb = torch.from_numpy(runs).to(cuda)
    luma = pixel.luminance(rgb).to(torch.uint8)
    tbl = torch.from_numpy(emit.ascii_glyph_table())
    got, got_len = emit.emit_truecolor_fg(rgb, luma, tbl)
    want, want_len = emit.emit_truecolor_fg_reference(rgb, luma, tbl)
    assert torch.equal(got_len, want_len)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_k6_refuses_a_glyph_table_on_the_card(cuda):
    rgb = torch.zeros((1, 2, 3, 3), dtype=torch.uint8, device=cuda)
    luma = torch.zeros((1, 2, 3), dtype=torch.uint8, device=cuda)
    tbl = torch.from_numpy(emit.ascii_glyph_table())
    with pytest.raises(ValueError, match="glyph_tbl"):
        emit.emit_truecolor_fg(rgb, luma, tbl.to(cuda))
    with pytest.raises(ValueError, match="luma"):
        emit.emit_truecolor_fg(rgb, luma.cpu(), tbl)


@pytest.mark.gpu
def test_frame_stager_on_the_card(cuda):
    """Each staged batch reaches the caller's stream whole: the caller's
    stream waits on its copy, and the copy into a slot waits on the work
    the caller enqueued before the call."""
    from asciichat_tpu_torch.runtime.device_stream import DeviceFrameStager

    stager = DeviceFrameStager(cuda)
    batches = [np.full((4, 270, 480, 3), v, np.uint8) for v in (1, 2, 3, 4, 5)]
    assert stager.stage(batches[0]) is None
    sums = []
    for i in range(1, len(batches)):
        got = stager.stage(batches[i])
        sums.append(got.to(torch.int64).sum())  # enqueued before the next stage()
    want = [int(b.astype(np.int64).sum()) for b in batches[:-1]]
    assert [int(s) for s in sums] == want
    assert int(stager.latest().to(torch.int64).sum()) == int(batches[-1].astype(np.int64).sum())
    stager.flush()


@pytest.mark.gpu
def test_overlapped_pipeline_on_the_card(cuda):
    """Convert, fetch and emit on their own streams and threads: every
    frame emitted under concurrency is the oracle's."""
    from asciichat_tpu_torch.render import emitter, oracle
    from asciichat_tpu_torch.render.pipeline import plan_render
    from asciichat_tpu_torch.runtime.device_stream import OverlappedRenderPipeline

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    plan = plan_render(640, 480, 80, 24, caps)
    frames = _frames(16, 480, 640, seed=9, device=cuda)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    want = [oracle.ascii_convert_with_capabilities(frames[i].cpu().numpy(), 80, 24, caps)
            for i in range(4)]
    wrong = []

    def step(f, r):
        for _ in range(3):
            recs = cells.render_cells(f, r, dst_h=plan.dst_h_px, dst_w=plan.dst_w,
                                      mode=plan.mode)
        return recs

    def emit(host):
        out = emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w,
                                  pad_h=plan.pad_h, nthreads=1, copy=False)
        wrong.extend(i for i, o in enumerate(out) if bytes(o) != want[i])
        return out

    pipe = OverlappedRenderPipeline(step, frames, ramp, emit, batch=16, k=3, fetch_slice=4)
    rates = pipe.run(seconds=1.0, warmup=0.3)
    assert rates["convert_fps"] > 0 and rates["d2h_fps"] > 0 and rates["emit_fps"] > 0
    assert pipe.emitted > 0 and wrong == []
