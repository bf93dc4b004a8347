"""Static assets of the browser client (the reference's web/ app role).

The app is real client-side code served as separate files (index.html +
ansi.js parser + renderer.js canvas drawer + acip.js protocol + app.js),
NOT a regex-to-HTML page: frames are parsed once into typed-array cell
grids and drawn by canvas blit (half-block pixel path) or per-cell diff.
`ansiparse.py` is the Python twin of ansi.js used by the golden tests.
"""

from __future__ import annotations

from pathlib import Path

_WEB_DIR = Path(__file__).parent

# route -> (content-type, filename)
ASSETS: dict[str, tuple[str, str]] = {
    "/": ("text/html; charset=utf-8", "index.html"),
    "/index.html": ("text/html; charset=utf-8", "index.html"),
    "/browse": ("text/html; charset=utf-8", "browse.html"),
    "/style.css": ("text/css", "style.css"),
    "/ansi.js": ("text/javascript", "ansi.js"),
    "/renderer.js": ("text/javascript", "renderer.js"),
    "/acip.js": ("text/javascript", "acip.js"),
    "/app.js": ("text/javascript", "app.js"),
}


def get_asset(path: str) -> tuple[str, bytes] | None:
    """(content_type, body) for a static route, or None."""
    entry = ASSETS.get(path.split("?", 1)[0])
    if entry is None:
        return None
    ctype, fname = entry
    return ctype, (_WEB_DIR / fname).read_bytes()
