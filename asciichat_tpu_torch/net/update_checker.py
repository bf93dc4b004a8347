"""Update checker — the lib/network/update_checker.c analog.

Semantics mirrored from the reference:

- Latest release from the GitHub API (``/repos/zfogg/ascii-chat/releases/
  latest``, ``tag_name`` + ``html_url`` — update_checker.c:37-39,204-227).
- Result cache at ``~/.config/ascii-chat/last_update_check``: three text
  lines — check timestamp, latest version, latest sha — fresh for 7 days
  (update_checker.c:29-32, update_check_save_cache/load_cache).
- Semantic-version triplet compare (lib/version.c version_compare).

Divergences for this environment: the check is STRICTLY OPT-IN (the apps
pass ``--update-check``; nothing fires by default — this box has zero
egress and an update check must never block or break startup), every
failure is silent, and the API base is injectable (``ASCIICHAT_UPDATE_URL``
or the ``api_base`` argument) so tests run against a local fake release
server, the same pattern as the fake UPnP/NAT-PMP routers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import urllib.request
from pathlib import Path

GITHUB_API = "https://api.github.com"
RELEASES_PATH = "/repos/zfogg/ascii-chat/releases/latest"
CACHE_MAX_AGE_S = 7 * 24 * 60 * 60  # update_checker.c:32


@dataclasses.dataclass
class UpdateCheckResult:
    """update_check_result_t (timestamp + latest version + sha)."""

    last_check_time: int = 0
    latest_version: str = ""
    # the reference caches a sha line (update_checker.c:29-32); the GitHub
    # releases API reports `target_commitish`, which for real releases is
    # usually a BRANCH name — stored as-is, labeled honestly
    latest_commitish: str = ""

    def is_fresh(self, now: float | None = None) -> bool:
        if self.last_check_time == 0:
            return False
        if now is None:  # NOT `now or ...`: an explicit 0.0 must count
            now = time.time()
        return (now - self.last_check_time) < CACHE_MAX_AGE_S


def parse_semver(v: str) -> tuple[int, int, int]:
    """'v1.2.3-rc1' -> (1, 2, 3). Delegates to utils.ui.parse_version —
    ONE comparator for the checker and the banner (they used to pad
    differently and could disagree on '1.2' vs '1.2.0')."""
    from asciichat_tpu_torch.utils.ui import parse_version

    return parse_version(v)


def version_compare(a: str, b: str) -> int:
    """-1/0/1 per lib/version.c version_compare (major, minor, patch)."""
    ta, tb = parse_semver(a), parse_semver(b)
    return (ta > tb) - (ta < tb)


def default_cache_path() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.expanduser("~/.config")
    return Path(base) / "ascii-chat" / "last_update_check"


class UpdateChecker:
    """Cached release check against the (injectable) GitHub API."""

    def __init__(self, current_version: str | None = None,
                 api_base: str | None = None,
                 cache_path: str | os.PathLike | None = None,
                 timeout: float = 3.0):
        from asciichat_tpu_torch.utils.ui import __version__

        self.current = current_version or __version__
        self.api_base = (api_base or os.environ.get("ASCIICHAT_UPDATE_URL")
                         or GITHUB_API).rstrip("/")
        self.cache_path = Path(cache_path) if cache_path else default_cache_path()
        self.timeout = timeout

    # -- cache (3-line text file, update_checker.c:141-181) ----------------
    def load_cache(self) -> UpdateCheckResult:
        try:
            lines = self.cache_path.read_text().splitlines()
            return UpdateCheckResult(int(lines[0]),
                                     lines[1] if len(lines) > 1 else "",
                                     lines[2] if len(lines) > 2 else "")
        except (OSError, ValueError, IndexError):
            return UpdateCheckResult()

    def save_cache(self, result: UpdateCheckResult) -> None:
        try:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            self.cache_path.write_text(
                f"{result.last_check_time}\n{result.latest_version}\n"
                f"{result.latest_commitish}\n")
        except OSError:
            pass  # cache is best-effort

    # -- network ------------------------------------------------------------
    def fetch_latest(self) -> UpdateCheckResult:
        """GET releases/latest; raises on any failure (callers gate it)."""
        with urllib.request.urlopen(self.api_base + RELEASES_PATH,
                                    timeout=self.timeout) as r:
            # cap the body: the timeout only bounds inter-chunk gaps, so an
            # unbounded read() lets a hijacked endpoint stream the process
            # out of memory during startup (the check must never break it)
            data = json.loads(r.read(1 << 20))
        tag = data.get("tag_name") or ""
        if not tag:
            raise ValueError("no tag_name in release JSON")
        return UpdateCheckResult(
            last_check_time=int(time.time()),
            latest_version=tag,
            latest_commitish=(data.get("target_commitish") or "")[:40],
        )

    # -- the check ------------------------------------------------------------
    def check(self, force: bool = False) -> str | None:
        """-> newer version string, or None (up to date / check failed).
        Uses the 7-day cache unless `force`; network failures are silent."""
        result = self.load_cache()
        if force or not result.is_fresh():
            try:
                result = self.fetch_latest()
                self.save_cache(result)
            except Exception:
                return None  # offline / refused / bad JSON: silently none
        if result.latest_version and version_compare(
                result.latest_version, self.current) > 0:
            return result.latest_version
        return None
