"""Command line of the port: the JAX package's parser, the port's mirror and
server.

    python -m asciichat_tpu_torch.apps.main mirror --test-pattern --snapshot
    python -m asciichat_tpu_torch.apps.main server --port 27224

The parser is ``asciichat_tpu.apps.main.build_parser()`` (JAX-free at module
level), so flags, help and defaults are the reference CLI's. ``mirror`` and
``server`` are ported; every other mode (client, discovery, ...), mirror's
``--render-file`` and ``--matrix``, and ``--config`` exit non-zero with "not
yet ported" and never run the JAX implementation. The device is
``ASCIICHAT_TORCH_DEVICE`` (``cuda`` by default, ``cpu`` for the plain
PyTorch versions).
"""

from __future__ import annotations

import sys

from asciichat_tpu.apps.main import build_parser
from asciichat_tpu.render.palette import BUILTIN_PALETTES
from asciichat_tpu.render.types import RenderMode
from asciichat_tpu.utils import logsys
from asciichat_tpu.utils.errors import AsciiChatError

NOT_PORTED = 2  # exit code of a mode or option the port does not have yet
PORTED_MODES = ("mirror", "server")


def _not_ported(what: str) -> int:
    print(f"asciichat_tpu_torch: {what} is not yet ported (ROADMAP.md Queue 1)",
          file=sys.stderr)
    return NOT_PORTED


def cmd_mirror(args) -> int:
    from asciichat_tpu.runtime.framesource import open_source
    from asciichat_tpu.utils import term
    from asciichat_tpu_torch.models.mirror import MirrorSession

    if args.render_file:
        return _not_ported("mirror --render-file")
    if args.matrix:
        return _not_ported("mirror --matrix")
    caps = term.detect_capabilities(RenderMode(args.render_mode), args.color_mode)
    w, h = term.terminal_size(args.width, args.height)
    source = open_source(test_pattern=args.test_pattern, file=args.file,
                         loop=args.loop, stdin_size=args.stdin_size)
    session = MirrorSession(
        source, caps, w, h, BUILTIN_PALETTES.get(args.palette, args.palette),
        fps_limit=args.fps, color_filter=args.color_filter,
        flip_x=args.flip_x, flip_y=args.flip_y, stretch=args.stretch,
        show_fps=args.show_fps,
    )
    if args.snapshot:
        session.run_snapshot()
        return 0
    session.run(max_frames=args.max_frames)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode not in PORTED_MODES:
        return _not_ported(f"mode {args.mode!r}")
    if getattr(args, "config", None):
        return _not_ported("--config")
    logsys.configure(
        level=getattr(args, "log_level", "INFO"),
        log_file=getattr(args, "log_file", None),
        grep=getattr(args, "grep", None),
        json_output=getattr(args, "log_json", False),
    )
    try:
        if args.mode == "server":
            from asciichat_tpu_torch.apps import server

            return server.main(args)
        return cmd_mirror(args)
    except AsciiChatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
