"""Digital rain (``mirror --matrix`` and the ``m`` key): the overlay as plain
PyTorch code on the frame's device.

Copied from ``asciichat_tpu/ops/rain.py`` (lib/video/anim/digital_rain.c).
The brightness field is a closed-form function of each (row, column) cell: a
sawtooth of (column_time - row) / drop_len with wobble (digital_rain.c:69-89):

  random_float(x,y) = fmod(sin(fmod(x*12.9898 + y*78.233, pi)) * 43758.5453, 1)
  wobble(x)         = x + 0.3 sin(sqrt2 x) + 0.2 sin(sqrt5 x)
  brightness        = 1 - fract(wobble((t_col - row) / drop_len))
  t_col             = offset_c + t * fall_speed * speed_c

Column randoms: offset = rf(c,0)*1000; speed = rf(c+0.1,0)*0.5+0.5
(digital_rain.c:32-44, 130-135). Defaults: fall 3.0, drop 12.0, color
(0,255,80), cursor boost 2.0 (digital_rain.h:105-144).

The column tables are numpy on the host and are uploaded once to the frame's
device. :func:`_brightness` and :func:`_overlay` are elementwise torch code:
rain is opt-in and runs once per displayed frame, so it is no kernel of its
own. The field is not bit for bit the JAX package's: XLA's CPU ``sin`` is
its own approximation and XLA contracts multiply-adds. Away from the
sawtooth's wrap (where ``wobble`` sits on an integer) the field agrees within
1e-4 and the overlaid frame within 1 (tests/test_torch_rain.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SQRT_2 = math.sqrt(2.0)
SQRT_5 = math.sqrt(5.0)


def _random_float(x: np.ndarray, y: float = 0.0) -> np.ndarray:
    dt = x * np.float32(12.9898) + np.float32(y * 78.233)
    sn = np.fmod(dt, np.float32(math.pi))
    return np.fmod(np.sin(sn) * np.float32(43758.5453), np.float32(1.0))


@dataclasses.dataclass
class DigitalRain:
    """Column state and parameters (digital_rain_t analog), its tables on
    ``device``."""

    num_columns: int
    num_rows: int
    fall_speed: float = 3.0
    raindrop_length: float = 12.0
    color: tuple[int, int, int] = (0, 255, 80)
    cursor_brightness: float = 2.0
    device: torch.device | str = "cpu"

    def __post_init__(self):
        self.device = torch.device(self.device)
        cols = np.arange(self.num_columns, dtype=np.float32)
        offset = (_random_float(cols) * 1000.0).astype(np.float32)
        speed = (_random_float(cols + np.float32(0.1)) * 0.5 + 0.5).astype(np.float32)
        self.time_offset = torch.from_numpy(offset).to(self.device)
        self.speed_multiplier = torch.from_numpy(speed).to(self.device)
        self._color = torch.tensor(self.color, dtype=torch.float32, device=self.device)

    def brightness_field(self, sim_time: float) -> torch.Tensor:
        """[rows, cols] float32 brightness at ``sim_time``, on the device."""
        return _brightness(self.time_offset, self.speed_multiplier, self.num_rows, sim_time,
                           self.fall_speed, self.raindrop_length)

    def apply(self, frame: torch.Tensor, sim_time: float) -> torch.Tensor:
        """Overlay rain on an RGB frame uint8 [H, W, 3] on the device (pixel
        rows are cells)."""
        return _overlay(frame, self.brightness_field(sim_time), self._color,
                        self.cursor_brightness)


def _brightness(offset: torch.Tensor, speed: torch.Tensor, num_rows: int, t: float,
                fall_speed: float, drop_len: float) -> torch.Tensor:
    """asciichat_tpu/ops/rain.py:_brightness, each constant rounded once to
    float32 as JAX's weak typing rounds it."""
    f32 = torch.float32
    dev = offset.device
    t = torch.tensor(t, dtype=f32, device=dev)
    col_time = offset + t * torch.tensor(fall_speed, dtype=f32, device=dev) * speed  # [C]
    rows = torch.arange(num_rows, dtype=f32, device=dev)[:, None]  # [R, 1]
    rain_time = (col_time[None, :] - rows) / torch.tensor(drop_len, dtype=f32, device=dev)
    wob = (rain_time + 0.3 * torch.sin(torch.tensor(SQRT_2, dtype=f32, device=dev) * rain_time)
           + 0.2 * torch.sin(torch.tensor(SQRT_5, dtype=f32, device=dev) * rain_time))
    return 1.0 - (wob - torch.floor(wob))


def _overlay(frame: torch.Tensor, brightness: torch.Tensor, color: torch.Tensor,
             cursor: float) -> torch.Tensor:
    """Matrix recoloring (asciichat_tpu/ops/rain.py:_overlay): rain-coloured
    monochrome, the source contributing only its luma; cells near the drop
    head (brightness ~ 1) flash toward white. The field must have the
    frame's [H, W]: ``FrameTransform`` builds the rain at the frame's size,
    so the JAX version's resize branch is not ported."""
    if tuple(brightness.shape) != tuple(frame.shape[:2]):
        raise ValueError(f"rain field {tuple(brightness.shape)} does not match the frame's "
                         f"{tuple(frame.shape[:2])}: build the rain at the frame's size")
    b = torch.clamp(brightness, 0.0, 1.0)[..., None]
    src = frame.to(torch.float32)
    luma = (0.299 * src[..., 0] + 0.587 * src[..., 1] + 0.114 * src[..., 2])[..., None]
    rain = color * (luma / 255.0 * 0.6 + 0.4) * b
    head = torch.clamp((b - 0.9) * 10.0, 0.0, 1.0) * torch.tensor(
        cursor - 1.0, dtype=torch.float32, device=frame.device)
    out = rain * (1.0 + head * 0.5) + head * 80.0
    return torch.clamp(out, 0, 255).to(torch.uint8)
