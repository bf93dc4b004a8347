"""Device mesh and shard plan for multi-device serving.

Counterpart of ``asciichat_tpu/parallel/mesh.py``. The reference scales by
spawning 2 render threads per client on one host (src/server/render.c:16-38).
The JAX package shards the server's render over a ("clients",) or
("clients", "space") mesh (SURVEY.md §5): each chip renders its share of the
receivers and, with a space axis, its share of every frame's cell rows.

Here a mesh is a grid of ``torch.device`` s, and the sharding is a shard
plan (:func:`shard_plan`): which contiguous receivers and which contiguous
cell rows each grid position renders. ``models/server.render_groups``
launches K3 once per grid position on that position's device, and the
records come back to the host in the unsharded layout. Nothing here is a
collective: the server copies the source stack to each other device of the
mesh once per tick (:func:`replicate`), where the JAX package all-gathers it.

One difference from the JAX package is deliberate. There
``ASCIICHAT_FORCE_MESH=N`` builds its N devices on the virtual CPU pool and
implies the CPU platform (asciichat_tpu/apps/main.py:209-221). Here it puts
N shards on the server's own device (the card by default, the CPU only
under ``ASCIICHAT_TORCH_DEVICE=cpu``) and never changes the device: on one
card the N shards' launches all go to that card.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from asciichat_tpu_torch.runtime.device import default_device

CLIENTS_AXIS = "clients"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (clients,) or (clients, space) grid of devices; a device may fill
    several positions."""

    devices: np.ndarray  # object array of torch.device, 1-D or 2-D
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """The extent of each axis by name: ``{"clients": N}`` or
        ``{"clients": N // K, "space": K}``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list[torch.device]:
        """The distinct devices of the grid, in grid order."""
        return list(dict.fromkeys(self.devices.flat))


def make_mesh(n_devices: int | None = None, space: int = 1, devices=None) -> Mesh:
    """1-D ("clients",) or 2-D ("clients", "space") mesh over the first
    ``n_devices`` of ``devices`` (every visible CUDA device when None); the
    same device may be given several times."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    if space > 1:
        if n % space:
            raise ValueError(f"{n} devices not divisible by space={space}")
        return Mesh(grid.reshape(n // space, space), (CLIENTS_AXIS, SPACE_AXIS))
    return Mesh(grid, (CLIENTS_AXIS,))


def serving_space_axis(n_devices: int) -> int:
    """The space-axis extent for the production mesh.

    ``ASCIICHAT_MESH_SPACE=K`` (K>1) splits the mesh into a 2D clients×space
    layout: each group's receivers shard over clients//K positions and the
    CELL-ROW axis of every frame shards over K (SURVEY §5's *pixels ×
    clients* axes). An extent that does not divide the device count is
    refused loudly, and the mesh stays 1-D."""
    raw = os.environ.get("ASCIICHAT_MESH_SPACE", "")
    if not (raw.isdigit() and int(raw) > 1):
        return 1
    space = int(raw)
    if n_devices % space != 0:
        from asciichat_tpu_torch.utils.logsys import get_logger

        get_logger("mesh").warning(
            "ASCIICHAT_MESH_SPACE=%d does not divide %d devices; "
            "serving on a 1D clients mesh", space, n_devices)
        return 1
    return space


def serving_mesh(device: torch.device | str | None = None) -> Mesh | None:
    """The production server's mesh for a server on ``device`` (the
    ``ASCIICHAT_TORCH_DEVICE`` device when None):

    - ``ASCIICHAT_FORCE_MESH=N`` (N>1): N shards, all on ``device``;
    - otherwise, on a CUDA device, a mesh over every visible CUDA device
      when there is more than one;
    - otherwise None: single-device serving.

    ``ASCIICHAT_MESH_SPACE=K`` makes either mesh 2-D (:func:`serving_space_axis`).
    Errors raise: a mesh that was asked for and cannot be built is not
    served around."""
    dev = torch.device(device) if device is not None else default_device()
    force = os.environ.get("ASCIICHAT_FORCE_MESH", "")
    if force.isdigit() and int(force) > 1:
        n = int(force)
        return make_mesh(n, space=serving_space_axis(n), devices=[dev] * n)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        return make_mesh(n, space=serving_space_axis(n))
    return None


@dataclasses.dataclass(frozen=True)
class Shard:
    """One grid position's part of a render: the receivers and the cell rows
    it renders, on its device. Either range may be empty."""

    index: int  # position in the flattened grid
    device: torch.device
    receivers: range
    rows: range


def split(n: int, parts: int) -> list[range]:
    """[0, n) cut into ``parts`` contiguous ranges of ceil(n / parts), the
    last ones shorter or empty: the layout an XLA sharding gives an n-long
    axis over ``parts`` devices."""
    step = -(-n // parts)
    return [range(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]


def shard_plan(mesh: Mesh, receivers: int, rows: int) -> list[Shard]:
    """The shards of a render of ``receivers`` x ``rows`` cell rows over
    ``mesh``, in grid order: receivers split over the clients axis, cell rows
    over the space axis."""
    grid = mesh.devices.reshape(mesh.devices.shape[0], -1)
    cs, rs = split(receivers, grid.shape[0]), split(rows, grid.shape[1])
    return [Shard(i * grid.shape[1] + j, grid[i, j], cs[i], rs[j])
            for i in range(grid.shape[0]) for j in range(grid.shape[1])]


def replicate(tensor: torch.Tensor, mesh: Mesh) -> dict[torch.device, torch.Tensor]:
    """``tensor`` on every device of ``mesh``: itself on its own device and
    one copy (``non_blocking``) on each other one."""
    out = {tensor.device: tensor}
    for d in mesh.device_list():
        if d not in out:
            out[d] = tensor.to(d, non_blocking=True)
    return out
