"""The server tick: N sources in, per-receiver cell records and per-client
exclude-self audio mixes out.

Counterpart of ``asciichat_tpu/models/server.py`` (``plan_tick``,
``render_compute``, ``tick_compute``, single-device ``RenderGroup`` and
``ServerTick``). Each video tick the server hands a :class:`RenderGroup` the
source stack; on a CUDA device :func:`render_group` launches K3
(``csrc/render_group.cu``), which gathers, filters, resizes and writes the
records in one pass; on the CPU it runs the plain version,
:func:`render_compute`. The audio half is ``ops/audio.mixer_process``: K4
(``csrc/mixer.cu``) on a CUDA device, the plain loop on the CPU.
:func:`tick_compute` and :class:`ServerTick` put both halves into one step.
The mesh path is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asciichat_tpu_torch.ops import audio as audio_ops
from asciichat_tpu_torch.ops import cells, compositor, filters, pixel
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import RenderPlan, plan_render
from asciichat_tpu_torch.render.types import RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime.device import check_tensor, default_device, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel
from asciichat_tpu_torch.utils import convert

RENDER_GROUP_KERNEL = Kernel(
    "render_group", "ac_render_group", "asciichat_tpu_torch/csrc/render_group.cu",
    "asciichat_tpu/models/server.py:58")


@dataclasses.dataclass(frozen=True)
class ServerTickPlan:
    """Static per-layout plan: recomputed on join/leave/resize, not per tick."""

    composite: compositor.CompositePlan
    render: RenderPlan
    num_clients: int
    audio_samples: int


def plan_tick(
    source_sizes: list[tuple[int, int]],
    term_w: int,
    term_h: int,
    caps: TerminalCapabilities,
    num_clients: int | None = None,
    audio_samples: int = audio_ops.AUDIO_FRAME_SAMPLES,
) -> ServerTickPlan:
    comp = compositor.plan_composite(source_sizes, term_w, term_h)
    # the server raises the height cap x2 for half-block clients (stream.c:831);
    # ascii_convert_with_capabilities then re-doubles into pixel rows (ascii.c:230)
    req_h = term_h * 2 if caps.render_mode == RenderMode.HALF_BLOCK else term_h
    render = plan_render(comp.width_px, comp.height_px, term_w, req_h, caps)
    n = num_clients if num_clients is not None else len(source_sizes)
    return ServerTickPlan(comp, render, n, audio_samples)


def render_compute(
    frames: torch.Tensor,  # uint8 [S, H, W, 3] latest frame per SOURCE
    ramp: torch.Tensor,
    tint: torch.Tensor,  # [C, 3] per-RECEIVER filter params (C may differ from S)
    fg_on_bg: torch.Tensor,
    is_rainbow: torch.Tensor,
    filter_on: torch.Tensor,
    cidx: torch.Tensor,
    src_y: torch.Tensor,
    src_x: torch.Tensor,
    comp_mask: torch.Tensor,
    *,
    mode: str,
    dst_h: int,
    dst_w: int,
) -> cells.RecordDict:
    """Plain version: composite gather -> per-receiver color filter ->
    batched cell records (asciichat_tpu/models/server.py:58-91)."""
    composite = compositor.composite_gather(frames, cidx, src_y, src_x, comp_mask)
    c = tint.shape[0]
    batch = composite.expand(c, *composite.shape)
    batch = filters.apply_color_filter(batch, tint, fg_on_bg, is_rainbow, filter_on)
    resized = pixel.resize_nn(batch, dst_h, dst_w)
    return cells.records_for_mode(resized, mode, ramp)


@dataclasses.dataclass(frozen=True, eq=False)
class GroupMaps:
    """A layout's gather maps on a device: the composite maps of the plain
    path ([Hc, Wc], host_maps order) and K3's composed maps ([dst_h_px,
    dst_w], cidx -1 = background), with the extents the maps index."""

    cidx: torch.Tensor
    src_y: torch.Tensor
    src_x: torch.Tensor
    comp_mask: torch.Tensor
    k_cidx: torch.Tensor
    k_sy: torch.Tensor
    k_sx: torch.Tensor
    n_src: int  # sources the maps reference (max cidx + 1)
    min_h: int  # rows and columns the source stack must have
    min_w: int


def render_group(frames: torch.Tensor, ramp: torch.Tensor, tint: torch.Tensor,
                 fg_on_bg: torch.Tensor, is_rainbow: torch.Tensor,
                 filter_on: torch.Tensor, maps: GroupMaps, *, mode: str,
                 dst_h: int, dst_w: int) -> cells.RecordDict:
    """The render of one group for one tick: K3 on a CUDA device, the plain
    :func:`render_compute` on the CPU."""
    if frames.device.type == "cpu":
        return render_compute(frames, ramp, tint, fg_on_bg, is_rainbow, filter_on,
                              maps.cidx, maps.src_y, maps.src_x, maps.comp_mask,
                              mode=mode, dst_h=dst_h, dst_w=dst_w)
    dev = frames.device
    family = cells.mode_family(mode)
    check_tensor(frames, "frames", torch.uint8, (None, None, None, 3), dev)
    s, h, w, _ = frames.shape
    if s < maps.n_src or h < maps.min_h or w < maps.min_w:
        raise ValueError(f"source stack {tuple(frames.shape)} is smaller than the "
                         f"layout's {maps.n_src} x {maps.min_h} x {maps.min_w}")
    for name, t in (("k_cidx", maps.k_cidx), ("k_sy", maps.k_sy), ("k_sx", maps.k_sx)):
        check_tensor(t, name, torch.int32, (dst_h, dst_w), dev)
    c = tint.shape[0]
    check_tensor(tint, "tint", torch.int32, (c, 3), dev)
    for name, t in (("fg_on_bg", fg_on_bg), ("is_rainbow", is_rainbow),
                    ("filter_on", filter_on)):
        check_tensor(t, name, torch.bool, (c,), dev)
    cells.check_ramp(ramp)
    records = cells.allocate_records(family, c, dst_h, dst_w, dev)
    if c and dst_h and dst_w:
        with torch.cuda.device(dev):
            RENDER_GROUP_KERNEL(
                family, frames.data_ptr(), h, w, maps.k_cidx.data_ptr(),
                maps.k_sy.data_ptr(), maps.k_sx.data_ptr(), dst_h, dst_w,
                tint.data_ptr(), fg_on_bg.data_ptr(), is_rainbow.data_ptr(),
                filter_on.data_ptr(), c, ramp.data_ptr(),
                *cells.record_pointers(records), stream_handle(dev))
    return records


class RenderGroup:
    """Live-server render group: the receivers sharing one (caps, size,
    palette) geometry, rendered from the shared source stack by one
    :func:`render_group` call per tick (the group is the batch dimension).
    Single device; rebuilt when the source layout or the geometry changes."""

    def __init__(
        self,
        source_sizes: list[tuple[int, int]],
        term_w: int,
        term_h: int,
        caps: TerminalCapabilities,
        filter_names: list[str],
        palette: str = pal.DEFAULT_PALETTE,
        device: torch.device | str | None = None,
    ):
        self._setup(plan_tick(source_sizes, term_w, term_h, caps,
                              num_clients=len(filter_names)),
                    filter_names, palette, device)

    @classmethod
    def from_plan(cls, plan: ServerTickPlan, filter_names: list[str],
                  palette: str = pal.DEFAULT_PALETTE,
                  device: torch.device | str | None = None) -> "RenderGroup":
        """The group of a plan that :func:`plan_tick` already made."""
        grp = cls.__new__(cls)
        grp._setup(plan, filter_names, palette, device)
        return grp

    def _setup(self, plan: ServerTickPlan, filter_names: list[str], palette: str,
               device: torch.device | str | None) -> None:
        self.render = plan.render
        self.palette = palette
        self.device = torch.device(device) if device is not None else default_device()
        # pinned buffers for the record fetch, reused tick after tick
        self.staging = cells.HostStaging() if self.device.type == "cuda" else None
        cidx, src_y, src_x, comp_mask = compositor.host_maps(plan.composite)
        self.load_state({"ramp": pal.char_index_ramp_array(palette), "cidx": cidx,
                         "src_y": src_y, "src_x": src_x, "comp_mask": comp_mask})
        self.filter_names: list[str] = []
        self.n_real = 0
        self.has_rainbow = False
        self.set_filters(filter_names)
        self.ticks = 0

    def load_state(self, arrays: dict[str, np.ndarray]) -> None:
        """Place host state on the group's device: any of the ramp, the
        filter vectors (tint, fg_on_bg, is_rainbow, filter_on) and the
        composite maps (cidx, src_y, src_x, comp_mask), under those names."""
        t = convert.to_torch(arrays, self.device)
        if "ramp" in t:
            self.ramp = t["ramp"]
        for name in ("tint", "fg_on_bg", "is_rainbow", "filter_on"):
            if name in t:
                setattr(self, name, t[name])
        if "cidx" in arrays:
            h, w = self.render.dst_h_px, self.render.dst_w
            maps = [arrays[k] for k in ("cidx", "src_y", "src_x", "comp_mask")]
            k_cidx, k_sy, k_sx = compositor.compose_maps(*maps, h, w)
            live = maps[3].reshape(maps[0].shape)
            k = convert.to_torch({"c": k_cidx, "y": k_sy, "x": k_sx}, self.device)
            self.maps = GroupMaps(
                t["cidx"], t["src_y"], t["src_x"], t["comp_mask"], k["c"], k["y"], k["x"],
                n_src=int(maps[0][live].max(initial=-1)) + 1,
                min_h=int(maps[1][live].max(initial=-1)) + 1,
                min_w=int(maps[2][live].max(initial=-1)) + 1)

    def set_filters(self, names: list[str], time_s: float = 0.0) -> None:
        """Per-receiver filter params are data. Rainbow tints are
        time-dependent (color_filter.c:169), so rainbow groups refresh the
        tint every tick."""
        self.filter_names = list(names)
        self.n_real = len(names)
        self.has_rainbow = "rainbow" in names
        tint, fg_on_bg, is_rainbow, enabled = filters.filter_params(self.filter_names, time_s)
        self.load_state({"tint": tint, "fg_on_bg": fg_on_bg,
                         "is_rainbow": is_rainbow, "filter_on": enabled})

    def _refresh_rainbow_tint(self, time_s: float) -> None:
        """Only `tint` depends on time (color_filter.c:169): re-upload it alone."""
        tint, _, _, _ = filters.filter_params(self.filter_names, time_s)
        self.load_state({"tint": tint})

    def step(self, frames: torch.Tensor, time_s: float = 0.0) -> cells.RecordDict:
        """frames uint8 [S, Hmax, Wmax, 3] on the group's device -> records
        for the group's receivers."""
        if self.has_rainbow:
            self._refresh_rainbow_tint(time_s)
        records = render_group(
            frames, self.ramp, self.tint, self.fg_on_bg, self.is_rainbow,
            self.filter_on, self.maps, mode=self.render.mode,
            dst_h=self.render.dst_h_px, dst_w=self.render.dst_w)
        self.ticks += 1
        return records

    def fetch(self, records: cells.RecordDict) -> dict[str, np.ndarray]:
        """The records of :meth:`step` on the host; through the group's
        pinned buffers on a CUDA device, so consume them before the next
        fetch."""
        return cells.records_to_numpy(records, self.staging)


def tick_compute(
    frames: torch.Tensor,  # uint8 [C, H, W, 3] latest frame per client
    audio: torch.Tensor,  # float32 [C, N]
    active: torch.Tensor,  # bool [C]
    mixer_state: tuple,
    ramp: torch.Tensor,
    tint: torch.Tensor,
    fg_on_bg: torch.Tensor,
    is_rainbow: torch.Tensor,
    filter_on: torch.Tensor,
    maps: GroupMaps,
    *,
    mode: str,
    dst_h: int,
    dst_w: int,
):
    """The full tick (asciichat_tpu/models/server.py:94-125): the render of
    :func:`render_group` and the exclude-self mixes of
    ``audio_ops.mixer_process``, so K3 + K4 on a CUDA device and the plain
    ``render_compute`` + ``mixer_process_reference`` on the CPU. The
    composite maps come as the layout's :class:`GroupMaps`."""
    records = render_group(frames, ramp, tint, fg_on_bg, is_rainbow, filter_on, maps,
                           mode=mode, dst_h=dst_h, dst_w=dst_w)
    mixes, mixer_state = audio_ops.mixer_process(audio, active, mixer_state)
    return records, mixes, mixer_state


class ServerTick:
    """Stateful wrapper owning the mixer state and the static plan arrays
    (asciichat_tpu/models/server.py:343-402)."""

    def __init__(
        self,
        plan: ServerTickPlan,
        palette: str = pal.DEFAULT_PALETTE,
        client_filters: list[str] | None = None,
        device: torch.device | str | None = None,
    ):
        self.plan = plan
        c = plan.num_clients
        # `is not None`: an empty list is a valid zero-receiver transient
        names = client_filters if client_filters is not None else ["none"] * c
        self.group = RenderGroup.from_plan(plan, names, palette, device)
        self.device = self.group.device
        self.mixer_state = audio_ops.MixerState.init(c, c, self.device).astuple()

    @property
    def consts(self) -> tuple:
        """The static per-layout arrays, in tick_compute argument order."""
        g = self.group
        return (g.ramp, g.tint, g.fg_on_bg, g.is_rainbow, g.filter_on, g.maps)

    def load_state(self, arrays: dict) -> None:
        """Place host state on the tick's device: the render group's arrays
        (RenderGroup.load_state) and the mixer state as ``mixer_state``, a
        tuple of four float32 arrays in MixerState.astuple() order."""
        arrays = dict(arrays)
        mixer = arrays.pop("mixer_state", None)
        if mixer is not None:
            self.mixer_state = convert.mixer_state(mixer, self.device)
        self.group.load_state(arrays)

    def step(self, frames: torch.Tensor, audio: torch.Tensor, active: torch.Tensor,
             time_s: float = 0.0) -> tuple[cells.RecordDict, torch.Tensor]:
        """frames uint8 [C, H, W, 3], audio float32 [C, N], active bool [C],
        all on the tick's device -> (records, mixes [C, N])."""
        if self.group.has_rainbow:
            # only tint is time-dependent (color_filter.c:169)
            self.group._refresh_rainbow_tint(time_s)
        render = self.plan.render
        records, mixes, self.mixer_state = tick_compute(
            frames, audio, active, self.mixer_state, *self.consts,
            mode=render.mode, dst_h=render.dst_h_px, dst_w=render.dst_w)
        return records, mixes
