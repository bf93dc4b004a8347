"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel-vs-plain tests need an NVIDIA card (marker ``gpu``) and skip
where ``torch.cuda.is_available()`` is false; on the card they run with
``python -m pytest tests/test_torch_kernels.py -m gpu``, and
``chip_smoke.py`` runs the same comparisons at the main path's full sizes.
The wrappers' checks and the CPU dispatch run everywhere. Tolerance: exact
for K1-K3 (uint8 records); K4's float32 mixes are held to rtol=2e-4,
atol=2e-5, the bound tests/test_audio.py holds the JAX mixer to.
"""

import numpy as np
import pytest
import torch

from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.models import server
from asciichat_tpu_torch.ops import audio, cells, pixel, resize
from asciichat_tpu_torch.runtime import kernel_build
from asciichat_tpu_torch.runtime.device import check_tensor, default_device, require_cuda


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
    m, r = grp.maps, grp.render
    want = server.render_compute(stack, grp.ramp, grp.tint, grp.fg_on_bg, grp.is_rainbow,
                                 grp.filter_on, m.cidx, m.src_y, m.src_x, m.comp_mask,
                                 mode=r.mode, dst_h=r.dst_h_px, dst_w=r.dst_w)
    for k in want:
        assert torch.equal(got[k], want[k]), k


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
    assert sources == {"resize.cu", "cell_records.cu", "render_group.cu", "mixer.cu"}
    for k in (resize.RESIZE_KERNEL, cells.CELL_RECORDS_KERNEL, server.RENDER_GROUP_KERNEL,
              audio.MIXER_KERNEL):
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
