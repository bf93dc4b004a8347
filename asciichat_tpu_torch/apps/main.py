"""Command line of the port: the reference CLI's parser and every mode of it.

    python -m asciichat_tpu_torch.apps.main mirror --test-pattern --snapshot
    python -m asciichat_tpu_torch.apps.main mirror --config c.toml --preset tiny --test-pattern
    python -m asciichat_tpu_torch.apps.main server --port 27224
    python -m asciichat_tpu_torch.apps.main client 127.0.0.1 --port 27224 --test-pattern
    python -m asciichat_tpu_torch.apps.main discovery-service --port 27225
    python -m asciichat_tpu_torch.apps.main discovery --port 27230
    python -m asciichat_tpu_torch.apps.main strings --count 3
    python -m asciichat_tpu_torch.apps.main query PID
    python -m asciichat_tpu_torch.apps.main completions bash
    python -m asciichat_tpu_torch.apps.main manpage
    python -m asciichat_tpu_torch.apps.main bench

:func:`build_parser` is built from the port's options registry
(``utils/options.py``) as ``asciichat_tpu/apps/main.py`` builds it, so flags,
help and defaults are the reference CLI's. Around the mode, :func:`main`
does what the JAX package's ``main()`` does: a ``--config`` TOML file (and its
``--preset``) fills the options the user did not type (:func:`apply_config`);
SIGUSR1 dumps every thread's stack into the per-pid file that ``query``
reads (``utils/dumps.py``), SIGUSR2 prints a gc report, and an unhandled
exception writes a panic report (:func:`install_handlers`). ``bench`` runs
the port's benchmark (``apps/bench.py``: one JSON line on stdout;
``ASCIICHAT_BENCH_SMOKE=1`` for tiny shapes); the repository's root
``bench.py`` drives the JAX package. ``client --webrtc``,
``discovery-service`` and ``discovery`` need the ``cryptography`` package
(X25519 and Ed25519 keys): without it they exit 1 with one line that says
so. The device is ``ASCIICHAT_TORCH_DEVICE``
(``cuda`` by default, ``cpu`` for the plain PyTorch versions); a client uses
it only for its audio capture chain. ``ASCIICHAT_FORCE_MESH`` and
``ASCIICHAT_MESH_SPACE`` shard the server's render (``parallel/mesh.py``)
and never change the device.
"""

from __future__ import annotations

import argparse
import os
import sys

from asciichat_tpu_torch.render.palette import BUILTIN_PALETTES
from asciichat_tpu_torch.render.types import RenderMode
from asciichat_tpu_torch.utils import logsys
from asciichat_tpu_torch.utils.errors import AsciiChatError
from asciichat_tpu_torch.utils.options import Mode, apply_to_parser, default_registry

def _update_banner() -> None:
    """The opt-in update check (update_checker.c + update_banner.c): a newer
    release prints the banner to stderr before the mode starts, so it never
    mixes into a frame stream. Every failure is silent."""
    from asciichat_tpu_torch.net.update_checker import UpdateChecker
    from asciichat_tpu_torch.utils import ui

    try:
        banner = ui.update_banner(ui.__version__, UpdateChecker().check())
    except Exception:
        return
    if banner:
        print(banner.decode(), file=sys.stderr)


def cmd_mirror(args) -> int:
    from asciichat_tpu_torch.models.mirror import MirrorSession
    from asciichat_tpu_torch.runtime.framesource import open_source
    from asciichat_tpu_torch.utils import term

    caps = term.detect_capabilities(RenderMode(args.render_mode), args.color_mode)
    w, h = term.terminal_size(args.width, args.height)
    palette = BUILTIN_PALETTES.get(args.palette, args.palette)
    # offline rendering decodes flat out; live playback is PTS-paced
    source = open_source(test_pattern=args.test_pattern, file=args.file,
                         loop=args.loop, pace=not args.render_file,
                         stdin_size=args.stdin_size)
    if args.render_file:
        from asciichat_tpu_torch.models.renderfile import render_to_file

        audio_source = None
        if args.tone_hz is not None or args.audio_wav:
            from asciichat_tpu_torch.runtime.audiodev import open_audio_source

            audio_source = open_audio_source(tone_hz=args.tone_hz,
                                             wav=args.audio_wav)
        # Y4M headers and the audio frame math need an integer rate >= 1:
        # a legal fractional --fps (0 < fps <= 144) must not truncate to 0
        # (invalid F0:1 header + ZeroDivisionError in the audio mux)
        n = render_to_file(source, args.render_file, caps, w, h, palette,
                           max_frames=args.max_frames or 300,
                           fps=max(1, round(args.fps)),
                           audio_source=audio_source)
        print(f"rendered {n} frames to {args.render_file}")
        return 0
    session = MirrorSession(
        source, caps, w, h, palette,
        fps_limit=args.fps, color_filter=args.color_filter,
        flip_x=args.flip_x, flip_y=args.flip_y, stretch=args.stretch,
        show_fps=args.show_fps, matrix=args.matrix,
    )
    if args.snapshot:
        session.run_snapshot()
        return 0
    session.run(max_frames=args.max_frames)
    return 0


def cmd_bench(args) -> int:
    from asciichat_tpu_torch.apps import bench

    return bench.main()


def cmd_server(args) -> int:
    from asciichat_tpu_torch.apps import server

    return server.main(args)


def _cryptography_missing(mode: str) -> bool:
    """WebRTC keys its ICE agent with X25519 (net/crypto.py) and the
    discovery modes sign every message with Ed25519 (net/identity.py):
    without `cryptography` say so on one line rather than with a
    traceback."""
    try:
        import cryptography  # noqa: F401
    except ImportError as e:
        print(f"error: {mode} needs the `cryptography` package, which cannot "
              f"be imported ({e})", file=sys.stderr)
        return True
    return False


def cmd_client(args) -> int:
    if args.webrtc and _cryptography_missing("client --webrtc"):
        return 1
    from asciichat_tpu_torch.apps import client

    return client.main(args)


def cmd_acds(args) -> int:
    if _cryptography_missing("discovery-service"):
        return 1
    from asciichat_tpu_torch.apps import acds

    return acds.main(args)


def cmd_discovery(args) -> int:
    if _cryptography_missing("discovery"):
        return 1
    from asciichat_tpu_torch.apps import discovery

    return discovery.main(args)


def cmd_strings(args) -> int:
    """Word-list helper (src/strings/main.c analog)."""
    from asciichat_tpu_torch.net.discovery import (
        ADJECTIVES, NOUNS, generate_session_string, validate_session_string,
    )

    if args.validate:
        ok = validate_session_string(args.validate)
        print("valid" if ok else "invalid")
        return 0 if ok else 1
    if args.list_words:
        print("adjectives:", " ".join(ADJECTIVES))
        print("nouns:", " ".join(NOUNS))
        return 0
    for _ in range(args.count):
        print(generate_session_string())
    return 0


def cmd_query(args) -> int:
    """Attach-to-live-PID inspector (ascii-query-server analog)."""
    from asciichat_tpu_torch.apps import query

    return query.main(args)


def cmd_completions(args) -> int:
    from asciichat_tpu_torch.utils.options import generate_completions

    print(generate_completions(default_registry(), args.shell))
    return 0


def cmd_manpage(args) -> int:
    from asciichat_tpu_torch.utils.options import generate_manpage

    print(generate_manpage(default_registry()))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI's parser (``asciichat_tpu/apps/main.py``), generated
    from the options registry: the same modes, flags, help and defaults.
    Only the ported modes carry a handler (``fn``)."""
    class _NoAbbrevParser(argparse.ArgumentParser):
        """allow_abbrev=False everywhere: prefix abbreviations ('--wid')
        would dodge the typed-flag detection of a config file."""

        def __init__(self, *a, **kw):
            kw.setdefault("allow_abbrev", False)
            super().__init__(*a, **kw)

    ap = _NoAbbrevParser(prog="asciichat-tpu",
                         description="TPU-native terminal video chat")
    sub = ap.add_subparsers(dest="mode", required=True,
                            parser_class=_NoAbbrevParser)
    reg = default_registry()

    m = sub.add_parser("mirror", help="local webcam->ASCII loop, no network")
    apply_to_parser(reg, m, Mode.MIRROR)
    m.set_defaults(fn=cmd_mirror)

    s = sub.add_parser("server", help="multi-client compositing server")
    apply_to_parser(reg, s, Mode.SERVER)
    s.set_defaults(fn=cmd_server)

    c = sub.add_parser("client", help="connect to a server")
    apply_to_parser(reg, c, Mode.CLIENT)
    c.set_defaults(fn=cmd_client)

    d = sub.add_parser("discovery-service", help="ACDS rendezvous server")
    apply_to_parser(reg, d, Mode.ACDS, default_overrides={"port": 27225})
    d.set_defaults(fn=cmd_acds)

    dc = sub.add_parser("discovery", help="P2P session via discovery service")
    apply_to_parser(reg, dc, Mode.DISCOVERY)
    dc.set_defaults(fn=cmd_discovery)

    b = sub.add_parser("bench", help="run the throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("strings", help="session word-string tool")
    st.add_argument("--count", type=int, default=1)
    st.add_argument("--validate", default=None)
    st.add_argument("--list-words", action="store_true")
    st.set_defaults(fn=cmd_strings, log_level="WARNING")

    q = sub.add_parser(
        "query", help="attach to a RUNNING asciichat pid: /proc state + "
                      "Python stacks (no --inspect-port needed)")
    q.add_argument("pid", type=int)
    q.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the report over HTTP instead of one-shot")
    q.add_argument("--force", action="store_true",
                   help="signal SIGUSR1 even if the pid doesn't look like "
                        "an asciichat process")
    q.set_defaults(fn=cmd_query, log_level="WARNING")

    comp = sub.add_parser("completions", help="generate shell completions")
    comp.add_argument("shell", choices=["bash", "zsh", "fish", "pwsh"])
    comp.set_defaults(fn=cmd_completions, log_level="WARNING")

    man = sub.add_parser("manpage", help="generate the troff man page")
    man.set_defaults(fn=cmd_manpage, log_level="WARNING")

    return ap


def apply_config(args: argparse.Namespace, argv: list[str]) -> None:
    """Layer the ``--config`` TOML file (and its ``--preset``) under the
    command line ``argv`` that gave ``args`` (lib/options/config/config.c
    semantics, as ``asciichat_tpu/apps/main.py`` layers it): a key the file
    sets fills its option unless the user typed that option; a width or
    height of 0 in the file stays auto. Only keys the file set are applied:
    the snapshot's registry defaults would override the CLI's positionals
    (the client's address) and per-mode defaults (the ACDS port). Values
    arrive converted through each option's cli_type, the CLI's own codec."""
    from asciichat_tpu_torch.utils.options import OptionsStore

    store = OptionsStore(default_registry())
    snap = store.load_toml(args.config, preset=getattr(args, "preset", None))
    # an option loses to the CLI only when the user actually typed it:
    # argparse defaults cannot tell "unset" for non-None defaults
    typed = {tok[2:].split("=", 1)[0] for tok in argv if tok.startswith("--")}
    vals = snap.as_dict()
    for key in store.last_toml_keys:
        attr = key.replace("-", "_")
        if not hasattr(args, attr) or key in typed or attr in typed:
            continue
        value = vals[key]
        if attr in ("width", "height") and value == 0:
            continue  # registry 0 means auto-detect
        setattr(args, attr, value)


def _dump_memory(*_) -> None:
    import gc

    print(f"--- gc: counts={gc.get_count()} objects={len(gc.get_objects())} ---",
          file=sys.stderr)


def _panic_hook(exc_type, exc, tb) -> None:
    """Panic reporter (src/tooling/panic analog): an unhandled exception
    writes a report with its traceback and every thread's stack before the
    process dies."""
    import tempfile
    import threading
    import traceback

    if issubclass(exc_type, (KeyboardInterrupt, BrokenPipeError)):
        sys.__excepthook__(exc_type, exc, tb)
        return
    try:
        path = os.path.join(tempfile.gettempdir(), f"asciichat-panic-{os.getpid()}.txt")
        with open(path, "w") as f:
            f.write("asciichat-tpu panic report\n\n")
            traceback.print_exception(exc_type, exc, tb, file=f)
            f.write("\n--- threads ---\n")
            frames = sys._current_frames()
            for t in threading.enumerate():
                f.write(f"\n{t.name}:\n")
                fr = frames.get(t.ident)
                if fr:
                    traceback.print_stack(fr, file=f)
        print(f"panic report written to {path}", file=sys.stderr)
    except Exception:
        pass
    sys.__excepthook__(exc_type, exc, tb)


def install_handlers() -> None:
    """The reference's sync-state and leak-report signals
    (src/main.c:323-338) and its panic reporter: SIGUSR1 dumps every
    thread's stack through faulthandler into the per-pid file of
    ``utils/dumps.py`` (written at C signal level without the GIL, so
    ``query`` reads the stacks of a deadlocked process), SIGUSR2 prints a gc
    report, and ``sys.excepthook`` writes a panic report."""
    import signal

    from asciichat_tpu_torch.utils.dumps import install_dump_handlers

    install_dump_handlers()
    try:
        signal.signal(signal.SIGUSR2, _dump_memory)
    except (ValueError, OSError, AttributeError):
        pass
    sys.excepthook = _panic_hook


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "config", None):
        apply_config(args, argv if argv is not None else sys.argv[1:])
    install_handlers()
    logsys.configure(
        level=getattr(args, "log_level", "INFO"),
        log_file=getattr(args, "log_file", None),
        grep=getattr(args, "grep", None),
        json_output=getattr(args, "log_json", False),
    )
    if getattr(args, "update_check", False):
        _update_banner()
    try:
        return args.fn(args)
    except AsciiChatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
