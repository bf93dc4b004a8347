"""The server tick: N sources in, per-receiver cell records and per-client
exclude-self audio mixes out.

Counterpart of ``asciichat_tpu/models/server.py`` (``plan_tick``,
``render_compute``, ``tick_compute``, single-device ``RenderGroup`` and
``ServerTick``). Each video tick the server hands :func:`render_groups` the
source stack and every geometry group it serves. On a CUDA device that is
one launch of K3 (``csrc/render_group.cu``) for all the groups: it gathers,
filters, resizes and writes every group's records into one device arena
(:class:`RecordArena`), which one copy fetches to the host. The receivers'
filters and the palette ramps stay on the host and ride by value in the
launch. On the CPU each group runs the plain version, :func:`render_compute`.
The audio half is ``ops/audio.mixer_process``: K4 (``csrc/mixer.cu``) on a
CUDA device, the plain loop on the CPU. :func:`tick_compute` and
:class:`ServerTick` put both halves into one step.

Groups built with a ``mesh`` (``parallel/mesh.py``) render sharded, as the
JAX package's mesh path does (asciichat_tpu/models/server.py:140-325): each
grid position renders its receivers x cell rows (``mesh.shard_plan``). On a
CUDA device that is one K3 launch per shard per tick, covering every group's
part in that shard, each shard's descriptors pointing at its first pixel
row of the group's word map and into a record buffer of its own
(:class:`MeshArena`, one per device), over the source stack copied once a
tick to each other device of the mesh; on the CPU each part is the plain
:func:`render_compute` of the shard's receivers, cut to its cell rows.
:meth:`MeshArena.fetch` gathers the parts on the host into the unsharded
layout, so the emitter sees what the single-device path gives it. The
receiver axis needs no padding: a shard with no receivers (or
no rows) of a group gets no descriptor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from asciichat_tpu_torch.ops import audio as audio_ops
from asciichat_tpu_torch.ops import cells, compositor, filters, pixel
from asciichat_tpu_torch.parallel import mesh as meshlib
from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.pipeline import RenderPlan, plan_render
from asciichat_tpu_torch.render.types import RenderMode, TerminalCapabilities
from asciichat_tpu_torch.runtime.device import check_tensor, default_device, stream_handle
from asciichat_tpu_torch.runtime.kernel_build import Kernel
from asciichat_tpu_torch.utils import convert

RENDER_GROUP_KERNEL = Kernel(
    "render_group", "ac_render_groups", "asciichat_tpu_torch/csrc/render_group.cu",
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


def cell_rows(family: int, hpx: int) -> int:
    """Cell rows of a render ``hpx`` pixel rows high in record ``family``."""
    return (hpx + 1) // 2 if family in cells.HALFBLOCK_FAMILIES else hpx


def pixel_rows(family: int, hpx: int, rows: range) -> tuple[int, int]:
    """The pixel rows [y0, y1) behind cell rows ``rows`` of a render ``hpx``
    pixel rows high. A half-block cell row r reads pixel rows 2r and
    ``hb_bot_row(r, hpx)`` (2r + 1, or 2r again in an odd frame's last row),
    so a shard of cell rows starts at an even pixel row, and only the last
    shard may hold an odd count of pixel rows."""
    if family in cells.HALFBLOCK_FAMILIES:
        return min(2 * rows.start, hpx), min(2 * rows.stop, hpx)
    return rows.start, rows.stop


# K3's limits; csrc/render_group.cu keeps the same numbers.
K3_MAX_GROUPS = 16  # descriptors per launch
K3_MAX_RECEIVERS = 16  # receivers per descriptor
K3_MAX_TILE_CELLS = 256  # cells per tile (CTA)
K3_DESC_WORDS = 25  # int64 words per descriptor in the host table
K3_MIN_TILE_CELLS = 16
# flag bits of a receiver's filter as K3 takes it
RECV_ENABLED, RECV_FG_ON_BG, RECV_RAINBOW = 1, 2, 4
ARENA_ALIGN = 16  # bytes: where each record starts in a RecordArena
MAP_NAMES = ("cidx", "src_y", "src_x", "comp_mask")  # compositor.host_maps order


@dataclasses.dataclass(eq=False)
class GroupMaps:
    """A layout's gather maps: the composite maps of the plain path ([Hc,
    Wc], host_maps order) on the group's device, and the composed maps
    ([dst_h_px, dst_w], cidx -1 = background) on the host, from which
    :meth:`words` makes K3's one-word map for a stack shape and keeps the
    last one."""

    cidx: torch.Tensor
    src_y: torch.Tensor
    src_x: torch.Tensor
    comp_mask: torch.Tensor
    k_cidx: np.ndarray
    k_sy: np.ndarray
    k_sx: np.ndarray
    n_src: int  # sources the maps reference (max cidx + 1)
    min_h: int  # rows and columns the source stack must have
    min_w: int
    # device -> (shape, map)
    _words: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_host(cls, arrays: dict[str, np.ndarray], dst_h: int, dst_w: int,
                  device: torch.device | str) -> "GroupMaps":
        """The maps of host arrays named as MAP_NAMES (compositor.host_maps
        order) for a [dst_h, dst_w] render, the composite maps on ``device``."""
        maps = [arrays[k] for k in MAP_NAMES]
        t = convert.to_torch(dict(zip(MAP_NAMES, maps)), device)
        live = maps[3].reshape(maps[0].shape)
        return cls(*t.values(), *compositor.compose_maps(*maps, dst_h, dst_w),
                   n_src=int(maps[0][live].max(initial=-1)) + 1,
                   min_h=int(maps[1][live].max(initial=-1)) + 1,
                   min_w=int(maps[2][live].max(initial=-1)) + 1)

    def words(self, stack_shape: tuple[int, ...],
              device: torch.device | None = None) -> torch.Tensor:
        """K3's map for a uint8 [S, H, W, 3] source stack: int32 [dst_h_px,
        dst_w] on ``device`` (the maps' device when None;
        compositor.pixel_words), made and uploaded when the shape differs
        from the last call's on that device."""
        device = self.cidx.device if device is None else torch.device(device)
        shape = tuple(stack_shape[:3])
        kept = self._words.get(device)
        if kept is None or kept[0] != shape:
            s, h, w = shape
            if s < self.n_src or h < self.min_h or w < self.min_w:
                raise ValueError(f"source stack {tuple(stack_shape)} is smaller than the "
                                 f"layout's {self.n_src} x {self.min_h} x {self.min_w}")
            host = compositor.pixel_words(self.k_cidx, self.k_sy, self.k_sx, shape)
            kept = self._words[device] = (shape, torch.from_numpy(host).to(device))
        return kept[1]


@dataclasses.dataclass(eq=False)
class K3Rows:
    """What a :class:`K3Job` keeps between launches: the descriptor rows of
    the last stack shape and records, and the word map and records that the
    rows point into, held here so that neither is freed while a row may be
    launched (the maps keep only their last shape's word map)."""

    shape: tuple[int, int, int]
    words: torch.Tensor | None  # None for a group without receivers
    records: cells.RecordDict | None = None
    sm_count: int = 0
    rows: list[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class K3Job:
    """One group's part of a K3 launch: its maps, record family and
    geometry, and the host values that ride by value in the launch's
    parameters (the palette ramp, each receiver's filter)."""

    maps: GroupMaps
    family: int
    hpx: int
    width: int
    ramp: np.ndarray  # uint8 [64]
    receivers: np.ndarray  # uint8 [C, 4] (receiver_words)
    y0: int = 0  # the maps' pixel row at which the job's hpx rows start (a row shard)
    kept: K3Rows | None = dataclasses.field(default=None, repr=False)

    def descriptors(self, stack_shape: tuple[int, ...], records: cells.RecordDict,
                    sm_count: int) -> list[np.ndarray]:
        """The job's rows of a K3 descriptor table (int64 [K3_DESC_WORDS]
        each, the layout of ac_render_groups in csrc/render_group.cu) for a
        render from a stack of ``stack_shape`` into ``records``: one row per
        K3_MAX_RECEIVERS receivers, none for an empty group. The rows are
        kept while the stack shape and the records hold (:class:`K3Rows`);
        only the receivers' filters are rewritten, since a rainbow tint
        moves."""
        shape = tuple(stack_shape[:3])
        kept = self.kept
        if kept is None or kept.shape != shape:
            device = next(iter(records.values())).device
            words = self.maps.words(shape, device) if len(self.receivers) else None
            kept = self.kept = K3Rows(shape, words)
        if kept.records is not records or kept.sm_count != sm_count:
            kept.rows = self._new_rows(kept.words, records, sm_count)
            kept.records, kept.sm_count = records, sm_count
        rows = kept.rows
        for i, row in enumerate(rows):
            c0 = i * K3_MAX_RECEIVERS
            part = self.receivers[c0:c0 + K3_MAX_RECEIVERS]
            row.view(np.uint8)[72:72 + part.size] = part.reshape(-1)
        return rows

    def _new_rows(self, words, records, sm_count) -> list[np.ndarray]:
        c = len(self.receivers)
        if not (c and self.hpx and self.width):
            return []
        tile_w = tile_width(cell_rows(self.family, self.hpx), self.width, sm_count)
        outs = [(t.data_ptr(), t.stride(0)) for t in records.values()]
        # a row shard's map starts at its first pixel row (K3 reads rows
        # 0..hpx-1 from the word pointer on)
        first = words.data_ptr() + self.y0 * self.width * words.element_size()
        rows = []
        for c0 in range(0, c, K3_MAX_RECEIVERS):
            row = np.zeros(K3_DESC_WORDS, np.int64)
            ptrs = [p + c0 * stride for p, stride in outs] + [0] * (3 - len(outs))
            row[:9] = (first, *ptrs, self.hpx, self.width, tile_w, self.family,
                       min(c - c0, K3_MAX_RECEIVERS))
            row.view(np.uint8)[136:200] = self.ramp
            rows.append(row)
        return rows


def receiver_words(tint: np.ndarray, fg_on_bg: np.ndarray, is_rainbow: np.ndarray,
                   enabled: np.ndarray) -> np.ndarray:
    """The filter vectors (filters.filter_params) as K3 takes them: uint8
    [C, 4], each receiver's tint r, g, b and its flags (RECV_*)."""
    tint = np.asarray(tint)
    if tint.size and (tint.min() < 0 or tint.max() > 255):
        raise ValueError("tint: every component must lie in 0..255")
    words = np.empty((tint.shape[0], 4), np.uint8)
    words[:, :3] = tint
    words[:, 3] = (np.asarray(enabled) * RECV_ENABLED | np.asarray(fg_on_bg) * RECV_FG_ON_BG
                   | np.asarray(is_rainbow) * RECV_RAINBOW)
    return words


def tile_width(rows: int, width: int, sm_count: int) -> int:
    """Cells per K3 tile for a group of ``rows`` cell rows: a row, or a
    chunk of it small enough that the group alone has about one tile per
    SM (one tile a row measured slower on the card, tools/k3_variants.py),
    at least K3_MIN_TILE_CELLS and at most K3_MAX_TILE_CELLS."""
    chunks = max(1, -(-sm_count // max(rows, 1)))
    return min(K3_MAX_TILE_CELLS, max(K3_MIN_TILE_CELLS, -(-width // chunks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class RecordArena:
    """The records of a render's groups in one device buffer and, on a CUDA
    device once :meth:`fetch` is first called, a pinned host buffer of the
    same layout, so that one copy fetches them all. Both are reused while
    the layout (each group's family, receivers and geometry) is unchanged,
    and grow when a layout needs more bytes. Records are views into them:
    consume them before the next render through the same arena, and the
    arrays of :meth:`fetch` before the next fetch."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._dev: torch.Tensor | None = None
        self._host: torch.Tensor | None = None
        self._layout: tuple = ()
        self._spans: list[list[tuple[str, tuple[int, ...], int]]] = []
        self._views: list[cells.RecordDict] = []
        self._host_views: list[dict[str, np.ndarray]] | None = None
        self._used = 0

    def layout(self, groups: list[tuple[int, int, int, int]]) -> list[cells.RecordDict]:
        """Record views for groups given as (family, receivers, hpx, width)."""
        key = tuple(groups)
        if key == self._layout and self._dev is not None:
            return self._views
        spans, used = [], 0
        for family, c, hpx, width in key:
            rows = cell_rows(family, hpx)
            span = []
            for name, trailing in cells.FAMILY_RECORDS[family]:
                shape = (c, rows, width, *trailing)
                span.append((name, shape, used))
                used += -(-math.prod(shape) // ARENA_ALIGN) * ARENA_ALIGN
            spans.append(span)
        if self._dev is None or self._dev.numel() < used:
            self._dev = torch.empty(used, dtype=torch.uint8, device=self.device)
        self._spans, self._used, self._layout = spans, used, key
        self._views = self._views_of(self._dev)
        self._host_views = None
        return self._views

    def _views_of(self, buf: torch.Tensor) -> list[cells.RecordDict]:
        return [{name: buf[o:o + math.prod(shape)].view(shape) for name, shape, o in span}
                for span in self._spans]

    def fetch(self, records: list[cells.RecordDict]) -> list[dict[str, np.ndarray]]:
        """``records`` on the host. On a CUDA device they must be this
        arena's last layout: one copy of its bytes into the pinned buffer,
        one wait for the stream, and the arrays are views of that buffer.
        On the CPU, the records as numpy."""
        if self.device.type != "cuda":
            return [cells.records_to_numpy(r) for r in records]
        if len(records) != len(self._views) or any(
                a is not b for a, b in zip(records, self._views)):
            raise ValueError("the records are not this arena's last layout")
        if self._host is None or self._host.numel() < self._dev.numel():
            self._host = torch.empty(self._dev.numel(), dtype=torch.uint8, pin_memory=True)
            self._host_views = None
        if self._host_views is None:
            self._host_views = [{k: v.numpy() for k, v in g.items()}
                                for g in self._views_of(self._host)]
        if self._used:
            self._host[:self._used].copy_(self._dev[:self._used], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        return self._host_views


def k3_tables(frames: torch.Tensor, jobs: list[K3Job], records: list[cells.RecordDict],
              sm_count: int) -> list[np.ndarray]:
    """K3's host descriptor tables for ``jobs`` rendering from ``frames``
    into ``records``: int64 [n, K3_DESC_WORDS], at most K3_MAX_GROUPS rows
    each, one launch per table (K3Job.descriptors)."""
    rows = [row for job, rec in zip(jobs, records)
            for row in job.descriptors(frames.shape, rec, sm_count)]
    if len(rows) == 1:
        return [rows[0][None]]
    return [np.stack(rows[i:i + K3_MAX_GROUPS]) for i in range(0, len(rows), K3_MAX_GROUPS)]


def _render_k3(frames: torch.Tensor, jobs: list[K3Job],
               arena: RecordArena) -> list[cells.RecordDict]:
    """Every job's records through K3 into ``arena``: one launch per
    K3_MAX_GROUPS descriptors."""
    dev = frames.device
    check_tensor(frames, "frames", torch.uint8, (None, None, None, 3), dev)
    if arena.device != dev:
        raise ValueError(f"record arena on {arena.device}, frames on {dev}")
    records = arena.layout([(j.family, len(j.receivers), j.hpx, j.width) for j in jobs])
    tables = k3_tables(frames, jobs, records, _sm_count(dev.index))
    if tables:
        with torch.cuda.device(dev):
            stream = stream_handle(dev)
            for table in tables:
                RENDER_GROUP_KERNEL(frames.data_ptr(), table.ctypes.data, len(table), stream)
    return records


def render_group(frames: torch.Tensor, ramp: torch.Tensor, tint: torch.Tensor,
                 fg_on_bg: torch.Tensor, is_rainbow: torch.Tensor,
                 filter_on: torch.Tensor, maps: GroupMaps, *, mode: str,
                 dst_h: int, dst_w: int) -> cells.RecordDict:
    """The render of one group from its arrays, the array-level mirror of
    the JAX ``render_compute`` call: K3 on a CUDA device, where the ramp and
    the filter vectors are host tensors that ride by value in the launch,
    the plain :func:`render_compute` on the CPU. Each call makes its launch
    job and its records afresh; :func:`render_groups` keeps both from tick
    to tick."""
    if frames.device.type == "cpu":
        return render_compute(frames, ramp, tint, fg_on_bg, is_rainbow, filter_on,
                              maps.cidx, maps.src_y, maps.src_x, maps.comp_mask,
                              mode=mode, dst_h=dst_h, dst_w=dst_w)
    host = torch.device("cpu")
    c = tint.shape[0]
    check_tensor(tint, "tint", torch.int32, (c, 3), host)
    for name, t in (("fg_on_bg", fg_on_bg), ("is_rainbow", is_rainbow),
                    ("filter_on", filter_on)):
        check_tensor(t, name, torch.bool, (c,), host)
    cells.check_ramp(ramp)
    if maps.k_cidx.shape != (dst_h, dst_w):
        raise ValueError(f"maps are for {maps.k_cidx.shape}, not ({dst_h}, {dst_w})")
    job = K3Job(maps, cells.mode_family(mode), dst_h, dst_w, ramp.numpy(),
                receiver_words(tint.numpy(), fg_on_bg.numpy(), is_rainbow.numpy(),
                               filter_on.numpy()))
    return _render_k3(frames, [job], RecordArena(frames.device))[0]


@dataclasses.dataclass(eq=False)
class ShardParts:
    """A group's records from a sharded render: its unsharded geometry and
    each shard's part, a record dict [the shard's receivers, its cell rows,
    width, ...] on the shard's device (shards with no receivers or no rows
    of the group have no part)."""

    family: int
    receivers: int
    rows: int
    width: int
    parts: list[tuple[meshlib.Shard, cells.RecordDict]]

    @classmethod
    def of(cls, job: K3Job) -> "ShardParts":
        """No parts yet, for the group whose whole launch job is ``job``."""
        return cls(job.family, len(job.receivers), cell_rows(job.family, job.hpx), job.width, [])


class MeshArena:
    """The records of a sharded render: on each device of the mesh a
    :class:`RecordArena` that holds every part the device's shards render
    (one fetch per device), and :meth:`fetch`, which gathers the parts on
    the host into the unsharded layout. ``copies`` is the number of copies
    of the source stack to other devices that the last render made."""

    def __init__(self, mesh: meshlib.Mesh):
        self.mesh = mesh
        self.arenas = {d: RecordArena(d) for d in mesh.device_list()}
        self._views: dict[torch.device, list[cells.RecordDict]] = {}
        self.copies = 0

    def layout(self, device: torch.device, jobs: list[K3Job]) -> list[cells.RecordDict]:
        """Record views on ``device`` for ``jobs``, the parts its shards render."""
        views = self._views[device] = self.arenas[device].layout(
            [(j.family, len(j.receivers), j.hpx, j.width) for j in jobs])
        return views

    def fetch(self, records: list[ShardParts]) -> list[dict[str, np.ndarray]]:
        """The groups' records on the host in the unsharded layout, fresh
        arrays for each call: one fetch per device of the parts in its arena
        (:meth:`RecordArena.fetch`, one copy on a CUDA device), then each
        part into its receivers and cell rows."""
        hosts: dict[int, dict[str, np.ndarray]] = {}
        for dev, arena in self.arenas.items():
            views = self._views.get(dev)
            if views:
                hosts.update(zip(map(id, views), arena.fetch(views)))
        out = []
        for g in records:
            full = {name: np.empty((g.receivers, g.rows, g.width, *trailing), np.uint8)
                    for name, trailing in cells.FAMILY_RECORDS[g.family]}
            for shard, rec in g.parts:
                host = hosts.get(id(rec))
                if host is None:  # a part of the plain render, not in an arena
                    host = cells.records_to_numpy(rec)
                c, r = shard.receivers, shard.rows
                for name, a in full.items():
                    a[c.start:c.stop, r.start:r.stop] = host[name]
            out.append(full)
        return out


def split_job(job: K3Job, mesh: meshlib.Mesh) -> list[tuple[meshlib.Shard, K3Job]]:
    """A group's launch job cut by the shard plan of ``mesh``: for each
    shard that holds some of its receivers and cell rows, the job that
    renders those receivers (views of ``job.receivers``, so a rainbow tint
    written there reaches them) from the shard's first pixel row of the
    group's maps (:func:`pixel_rows`)."""
    out = []
    for shard in meshlib.shard_plan(mesh, len(job.receivers), cell_rows(job.family, job.hpx)):
        if not (shard.receivers and shard.rows):
            continue  # no part of the group here: no descriptor
        y0, y1 = pixel_rows(job.family, job.hpx, shard.rows)
        c = shard.receivers
        out.append((shard, K3Job(job.maps, job.family, y1 - y0, job.width, job.ramp,
                                 job.receivers[c.start:c.stop], y0=job.y0 + y0)))
    return out


def shard_launches(stacks: dict[torch.device, torch.Tensor],
                   groups: list[tuple[K3Job, list[tuple[meshlib.Shard, K3Job]]]],
                   arena: MeshArena, sm_count) -> tuple[list[ShardParts], list[tuple]]:
    """The K3 side of a sharded render, launching nothing. ``groups`` holds
    each group's whole job and its :func:`split_job`. Every part is laid
    out in the arena of its shard's device, and the launches that render
    them are (stack, descriptor table) pairs, one per shard (one per
    K3_MAX_GROUPS descriptors), each over the stack on the shard's device.
    ``sm_count(device)`` sizes the tiles."""
    out = [ShardParts.of(job) for job, _ in groups]
    launches = []
    for dev in arena.arenas:
        placed = sorted(((shard, gi, job) for gi, (_, parts) in enumerate(groups)
                         for shard, job in parts if shard.device == dev),
                        key=lambda p: (p[0].index, p[1]))
        records = arena.layout(dev, [job for _, _, job in placed])
        for (shard, gi, _), rec in zip(placed, records):
            out[gi].parts.append((shard, rec))
        for index in dict.fromkeys(shard.index for shard, _, _ in placed):
            mine = [(job, rec) for (shard, _, job), rec in zip(placed, records)
                    if shard.index == index]
            tables = k3_tables(stacks[dev], [j for j, _ in mine], [r for _, r in mine],
                               sm_count(dev))
            launches += [(stacks[dev], table) for table in tables]
    return out, launches


def _render_sharded(frames: torch.Tensor, groups: list["RenderGroup"],
                    arena: MeshArena) -> list[ShardParts]:
    """Every group's shards, from ``frames`` copied to each other device of
    the mesh (the JAX package all-gathers the stack): on a CUDA device one
    K3 launch per shard (per K3_MAX_GROUPS descriptors) over its parts of
    every group, on the CPU the plain :func:`render_compute` of each part's
    receivers, cut to its cell rows."""
    stacks = meshlib.replicate(frames, arena.mesh)
    arena.copies = len(stacks) - 1
    if frames.device.type == "cpu":
        out = []
        for g in groups:
            out.append(ShardParts.of(g.job))
            for shard, _ in g.shard_jobs:
                c = slice(shard.receivers.start, shard.receivers.stop)
                rec = render_compute(stacks[shard.device], g.ramp, g.tint[c], g.fg_on_bg[c],
                                     g.is_rainbow[c], g.filter_on[c], g.maps.cidx,
                                     g.maps.src_y, g.maps.src_x, g.maps.comp_mask,
                                     mode=g.render.mode, dst_h=g.render.dst_h_px,
                                     dst_w=g.render.dst_w)
                r = slice(shard.rows.start, shard.rows.stop)
                out[-1].parts.append((shard, {k: v[:, r] for k, v in rec.items()}))
        return out
    check_tensor(frames, "frames", torch.uint8, (None, None, None, 3), frames.device)
    out, launches = shard_launches(stacks, [(g.job, g.shard_jobs) for g in groups], arena,
                                   lambda d: _sm_count(d.index))
    for frames, table in launches:
        dev = frames.device
        with torch.cuda.device(dev):
            RENDER_GROUP_KERNEL(frames.data_ptr(), table.ctypes.data, len(table),
                                stream_handle(dev))
    return out


def render_groups(frames: torch.Tensor, groups: list["RenderGroup"], time_s: float = 0.0,
                  arena: RecordArena | MeshArena | None = None
                  ) -> list[cells.RecordDict] | list[ShardParts]:
    """One tick's render of every group from one source stack, one record
    dict per group. Rainbow tints follow ``time_s`` (on the host). On a
    CUDA device: one K3 launch for all the groups (one per K3_MAX_GROUPS
    descriptors), the records in ``arena`` (a fresh one when None), to be
    fetched with its :meth:`RecordArena.fetch`. On the CPU: the plain
    :func:`render_compute` of each group, and ``arena`` is not used.

    Groups built on a mesh (all on the same one) render sharded
    (:func:`_render_sharded`) into ``arena``, a :class:`MeshArena` of that
    mesh (a fresh one when None), one :class:`ShardParts` per group for its
    :meth:`MeshArena.fetch`."""
    mesh = groups[0].mesh if groups else None
    if any(g.mesh is not mesh for g in groups):
        raise ValueError("the groups of one render share one mesh, or none")
    rgb = None
    for g in groups:
        if g.device != frames.device:
            raise ValueError(f"group on {g.device}, frames on {frames.device}")
        if g.has_rainbow:
            rgb = rgb or filters.rainbow_color(time_s)
            g._set_rainbow_tint(rgb)
    if mesh is not None:
        if arena is None:
            arena = MeshArena(mesh)
        if not isinstance(arena, MeshArena) or arena.mesh is not mesh:
            raise ValueError("a sharded render needs a MeshArena of the groups' mesh")
        records = _render_sharded(frames, groups, arena)
    elif frames.device.type == "cpu":
        records = [render_compute(frames, g.ramp, g.tint, g.fg_on_bg, g.is_rainbow,
                                  g.filter_on, g.maps.cidx, g.maps.src_y, g.maps.src_x,
                                  g.maps.comp_mask, mode=g.render.mode,
                                  dst_h=g.render.dst_h_px, dst_w=g.render.dst_w)
                   for g in groups]
    else:
        records = _render_k3(frames, [g.job for g in groups],
                             arena if arena is not None else RecordArena(frames.device))
    for g in groups:
        g.ticks += 1
    return records


class RenderGroup:
    """Live-server render group: the receivers sharing one (caps, size,
    palette) geometry, rendered from the shared source stack (the receivers
    are the batch dimension) by :func:`render_groups` beside the tick's
    other groups, or alone by :meth:`step`. The ramp and the filter vectors
    stay on the host. Rebuilt when the source layout or the geometry
    changes. With ``mesh`` (``parallel/mesh.py``) the group renders sharded:
    :attr:`shard_jobs` holds its part of each shard, and its arena is a
    :class:`MeshArena`."""

    def __init__(
        self,
        source_sizes: list[tuple[int, int]],
        term_w: int,
        term_h: int,
        caps: TerminalCapabilities,
        filter_names: list[str],
        palette: str = pal.DEFAULT_PALETTE,
        device: torch.device | str | None = None,
        mesh: meshlib.Mesh | None = None,
    ):
        self._setup(plan_tick(source_sizes, term_w, term_h, caps,
                              num_clients=len(filter_names)),
                    filter_names, palette, device, mesh)

    @classmethod
    def from_plan(cls, plan: ServerTickPlan, filter_names: list[str],
                  palette: str = pal.DEFAULT_PALETTE,
                  device: torch.device | str | None = None,
                  mesh: meshlib.Mesh | None = None) -> "RenderGroup":
        """The group of a plan that :func:`plan_tick` already made."""
        grp = cls.__new__(cls)
        grp._setup(plan, filter_names, palette, device, mesh)
        return grp

    def _setup(self, plan: ServerTickPlan, filter_names: list[str], palette: str,
               device: torch.device | str | None, mesh: meshlib.Mesh | None) -> None:
        self.render = plan.render
        self.palette = palette
        self.device = torch.device(device) if device is not None else default_device()
        self.mesh = mesh
        self.family = cells.mode_family(self.render.mode)
        # the records of step(), reused tick after tick
        self.arena = MeshArena(mesh) if mesh is not None else RecordArena(self.device)
        cidx, src_y, src_x, comp_mask = compositor.host_maps(plan.composite)
        self.load_state({"ramp": pal.char_index_ramp_array(palette), "cidx": cidx,
                         "src_y": src_y, "src_x": src_x, "comp_mask": comp_mask})
        self.filter_names: list[str] = []
        self.n_real = 0
        self.has_rainbow = False
        self.set_filters(filter_names)
        self.ticks = 0

    def load_state(self, arrays: dict[str, np.ndarray]) -> None:
        """Place state: any of the ramp and the filter vectors (tint,
        fg_on_bg, is_rainbow, filter_on), which stay on the host, and the
        composite maps (cidx, src_y, src_x, comp_mask), which go to the
        group's device, under those names."""
        t = convert.to_torch({k: v for k, v in arrays.items() if k not in MAP_NAMES},
                             self.device)
        if "ramp" in t:
            self.ramp = t["ramp"]
        for name in ("tint", "fg_on_bg", "is_rainbow", "filter_on"):
            if name in t:
                setattr(self, name, t[name])
        if "cidx" in arrays:
            self.maps = GroupMaps.from_host(arrays, self.render.dst_h_px, self.render.dst_w,
                                            self.device)
        self._job: K3Job | None = None  # rebuilt from the new state
        self._shard_jobs: list[tuple[meshlib.Shard, K3Job]] | None = None
        self._rainbow_rows: list[int] | None = None

    @property
    def job(self) -> K3Job:
        """The group's part of a K3 launch, rebuilt after a change of state."""
        if self._job is None:
            cells.check_ramp(self.ramp)
            self._job = K3Job(self.maps, self.family, self.render.dst_h_px, self.render.dst_w,
                              self.ramp.numpy(),
                              receiver_words(self.tint.numpy(), self.fg_on_bg.numpy(),
                                             self.is_rainbow.numpy(), self.filter_on.numpy()))
        return self._job

    @property
    def shard_jobs(self) -> list[tuple[meshlib.Shard, K3Job]]:
        """:attr:`job` cut by the shard plan of the group's mesh
        (:func:`split_job`), rebuilt with it."""
        if self._shard_jobs is None:
            self._shard_jobs = split_job(self.job, self.mesh)
        return self._shard_jobs

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

    def _set_rainbow_tint(self, rgb: tuple[int, int, int]) -> None:
        """Only `tint` depends on time (color_filter.c:169): rewrite the
        rainbow receivers' tint in place on the host, where K3 takes it by
        value."""
        if self._rainbow_rows is None:
            self._rainbow_rows = np.flatnonzero(self.is_rainbow.numpy()).tolist()
            self._tint_host = self.tint.numpy()
        receivers = None if self._job is None else self._job.receivers
        for i in self._rainbow_rows:  # rows one by one: a group has few
            self._tint_host[i] = rgb
            if receivers is not None:
                receivers[i, :3] = rgb

    def step(self, frames: torch.Tensor, time_s: float = 0.0) -> cells.RecordDict | ShardParts:
        """frames uint8 [S, Hmax, Wmax, 3] on the group's device -> records
        for the group's receivers: :func:`render_groups` of this group
        alone, through the group's own arena (so the records are reused by
        the next step); on a mesh, the group's :class:`ShardParts`."""
        return render_groups(frames, [self], time_s, self.arena)[0]

    def fetch(self, records: cells.RecordDict | ShardParts) -> dict[str, np.ndarray]:
        """The records of the last :meth:`step` on the host: through the
        arena's pinned buffer on a CUDA device, so consume them before the
        next fetch."""
        return self.arena.fetch([records])[0]


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
    """The full tick from its arrays (asciichat_tpu/models/server.py:94-125):
    the render of :func:`render_group` and the exclude-self mixes of
    ``audio_ops.mixer_process``, so K3 + K4 on a CUDA device and the plain
    ``render_compute`` + ``mixer_process_reference`` on the CPU. The
    composite maps come as the layout's :class:`GroupMaps`. The same two
    halves as :meth:`ServerTick.step`, which keeps its group's launch job
    and records from tick to tick."""
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
        all on the tick's device -> (records, mixes [C, N]). On a CUDA
        device the records are the group's arena, reused by the next step."""
        # tick_compute's two halves, the render through the group's kept
        # K3 job and arena (RenderGroup.step refreshes the rainbow tint)
        records = self.group.step(frames, time_s)
        mixes, self.mixer_state = audio_ops.mixer_process(audio, active, self.mixer_state)
        return records, mixes
