"""UI chrome: splash banner, status line, keyboard help overlay.

Parity with lib/ui/ (splash.c animated banner, fps_counter.c overlay,
status screen, keyboard help).
"""

from __future__ import annotations

import time

SPLASH = r"""
   __ _ ___  ___(_|_)       ___| |__   __ _| |_
  / _` / __|/ __| | |_____ / __| '_ \ / _` | __|
 | (_| \__ \ (__| | |_____| (__| | | | (_| | |_
  \__,_|___/\___|_|_|      \___|_| |_|\__,_|\__|  tpu
"""

KEY_HELP = [
    ("q", "quit"),
    ("f", "flip horizontally"),
    ("m", "toggle matrix rain"),
    ("c", "cycle color filter"),
    ("s", "toggle fps overlay"),
    ("?", "toggle this help"),
]


def splash_frames(columns: int = 60, steps: int = 8) -> list[bytes]:
    """Simple reveal animation of the banner (splash.c analog)."""
    lines = [ln for ln in SPLASH.strip("\n").split("\n")]
    frames = []
    # reveal width must cover the LONGEST banner line (the last line carries
    # the "tpu" suffix and is wider than lines[0]; using lines[0] left the
    # suffix permanently truncated)
    full = max(len(ln) for ln in lines)
    for step in range(1, steps + 1):
        visible = int(full * step / steps) + (0 if step == steps else 4)
        frame = "\n".join(ln[:visible].center(columns)[:columns] for ln in lines)
        frames.append(frame.encode())
    return frames


def help_overlay() -> bytes:
    width = max(len(f"  {k}  {desc}") for k, desc in KEY_HELP) + 4
    top = "+" + "-" * (width - 2) + "+"
    rows = [top, "|" + " keys ".center(width - 2, "-") + "|"]
    for k, desc in KEY_HELP:
        rows.append(("| " + f"{k}  {desc}").ljust(width - 1) + "|")
    rows.append(top)
    return "\n".join(rows).encode()


def status_line(fps: float, frames: int, mode: str, size: tuple[int, int],
                extra: str = "") -> bytes:
    s = (f"\x1b[7m {fps:5.1f} fps | {frames} frames | {mode} | "
         f"{size[0]}x{size[1]} {extra}\x1b[0m")
    return s.encode()


class Stats:
    """Server stats aggregate (src/server/stats.c analog)."""

    def __init__(self):
        self.start = time.monotonic()
        self.frames_rendered = 0
        self.frames_sent = 0
        self.bytes_sent = 0
        self.clients_peak = 0

    def report(self, num_clients: int) -> str:
        self.clients_peak = max(self.clients_peak, num_clients)
        up = time.monotonic() - self.start
        fps = self.frames_rendered / up if up > 0 else 0.0
        return (f"uptime={up:.0f}s clients={num_clients} (peak {self.clients_peak}) "
                f"rendered={self.frames_rendered} ({fps:.1f}/s) "
                f"sent={self.frames_sent} bytes={self.bytes_sent}")


class StatusScreen:
    """Server status screen with a live log feed (lib/ui/status.c +
    terminal_screen.c): a boxed header (mode, listen address, session
    string, uptime, client count, stats) above the newest ring-log lines,
    re-rendered at the display rate. `render()` returns one full frame of
    bytes; the caller owns the write cadence (server status loop)."""

    def __init__(self, mode_name: str, get_status, width: int = 80,
                 height: int = 24, grep: str | None = None):
        self.mode_name = mode_name
        self.get_status = get_status  # -> dict of header fields
        self.width = width
        self.height = height
        self.grep = grep
        self.start = time.monotonic()

    def _header_lines(self) -> list[str]:
        st = self.get_status() or {}
        up = time.monotonic() - self.start
        lines = [f"ascii-chat {self.mode_name} — up {int(up) // 60}m{int(up) % 60:02d}s"]
        for key, value in st.items():
            lines.append(f"{key}: {value}")
        return lines

    def render(self) -> bytes:
        from asciichat_tpu_torch.utils.logsys import ring_log

        w = self.width
        out = []
        bar = "+" + "-" * (w - 2) + "+"
        out.append(bar)
        for ln in self._header_lines():
            out.append("| " + ln[: w - 4].ljust(w - 4) + " |")
        out.append(bar)
        # live log feed fills the remaining rows (status.c log feed).
        # remaining <= 0 must SKIP the fetch: tail(0) is the [-0:] slice
        # pitfall (returns the whole ring) and a negative limit slices most
        # of it — hundreds of entries formatted 4x/s for zero visible rows
        remaining = max(0, self.height - len(out))
        if remaining:
            entries = (ring_log.search(self.grep, remaining) if self.grep
                       else ring_log.tail(remaining))
        else:
            entries = []
        for created, level, name, msg in entries[-remaining:] if remaining else []:
            ts = time.strftime("%H:%M:%S", time.localtime(created))
            out.append(f"{ts} {level[:3]} {name}: {msg}"[:w])
        while len(out) < self.height:
            out.append("")
        return "\n".join(out[: self.height]).encode()


def multi_pane(panes: list[bytes], width: int, height: int) -> bytes:
    """Compose multiple ASCII panes with |/_/+ separators — the ASCII-space
    grid (render/asciigrid.create_grid, ascii.c:602) as a UI primitive."""
    from asciichat_tpu_torch.render.asciigrid import create_grid

    return create_grid(panes, width, height)


# ---------------------------------------------------------------------------
# Update banner (lib/ui/update_banner.c): compares the running version with
# the latest release and renders a one-line notice. The network check is
# OPT-IN (ASCIICHAT_UPDATE_CHECK=1) and fails silently — this environment has
# zero egress, and an update check must never block or break startup.

__version__ = "0.2.0"


def parse_version(v: str) -> tuple[int, int, int]:
    """'v1.2.3-rc1' -> (1, 2, 3); missing parts read as 0 (version.c).
    THE version comparator — net/update_checker.py delegates here, so the
    checker's decision and the banner's can never disagree on forms like
    '1.2' vs '1.2.0'."""
    import re

    nums = re.findall(r"\d+", v)[:3]
    nums += ["0"] * (3 - len(nums))
    return tuple(int(x) for x in nums)  # type: ignore[return-value]


def update_banner(current: str, latest: str | None) -> bytes | None:
    """-> banner bytes when `latest` is newer, else None (update_banner.c
    render rule)."""
    if not latest or parse_version(latest) <= parse_version(current):
        return None
    return (f"\x1b[33m*** update available: {latest} "
            f"(running {current}) ***\x1b[0m").encode()


def check_for_update(fetch=None) -> bytes | None:
    """Gated update check: returns a banner or None. `fetch` is injectable
    for tests; the default only fires with ASCIICHAT_UPDATE_CHECK=1 and goes
    through the full cached checker (net/update_checker.py: GitHub API
    shape, 7-day cache file, semver compare — update_checker.c analog)."""
    import os

    if fetch is None:
        if os.environ.get("ASCIICHAT_UPDATE_CHECK") != "1":
            return None
        from asciichat_tpu_torch.net.update_checker import UpdateChecker

        return update_banner(__version__, UpdateChecker().check())

    try:
        latest = fetch()
    except Exception:
        return None  # zero egress / offline: silently no banner
    return update_banner(__version__, latest)
