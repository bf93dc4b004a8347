"""Options system: the domain registry and the argparse surface built from it.

Copied from ``asciichat_tpu/utils/options.py`` (the reference's lib/options/,
SURVEY §2c):
- single-source registry of descriptors grouped by domain with per-mode
  bitmasks (lib/options/registry/*.c)
- the argparse surface generated from it (the reference's option generators)

The TOML config store and the completion and man page generators stay in
the JAX package: ``--config``, ``completions`` and ``manpage`` are not yet
ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable


class Mode(enum.IntFlag):
    """Per-mode applicability bitmask (lib/options/registry mode masks)."""

    MIRROR = 1
    SERVER = 2
    CLIENT = 4
    DISCOVERY = 8
    ACDS = 16
    ALL = 31


@dataclasses.dataclass(frozen=True)
class OptionDescriptor:
    name: str
    domain: str
    type: type
    default: Any
    help: str
    modes: Mode = Mode.ALL
    choices: tuple | None = None
    validator: Callable[[Any], bool] | None = None
    short: str | None = None
    # argparse-surface metadata:
    cli_type: Callable[[str], Any] | None = None  # CLI string converter
    positional: bool = False  # bare argument instead of --flag


class OptionsRegistry:
    def __init__(self):
        self._descriptors: dict[str, OptionDescriptor] = {}

    def register(self, desc: OptionDescriptor) -> None:
        if desc.name in self._descriptors:
            raise ValueError(f"duplicate option {desc.name!r}")
        self._descriptors[desc.name] = desc

    def add(self, name: str, domain: str, type_: type, default: Any, help_: str,
            **kw) -> None:
        self.register(OptionDescriptor(name, domain, type_, default, help_, **kw))

    def descriptors(self, mode: Mode | None = None, domain: str | None = None):
        for d in self._descriptors.values():
            if mode is not None and not (d.modes & mode):
                continue
            if domain is not None and d.domain != domain:
                continue
            yield d


# ---------------------------------------------------------------------------
# The argparse surface, generated from the registry: the CLI is GENERATED
# from descriptors so flags and help cannot drift.


def apply_to_parser(registry: OptionsRegistry, parser, mode: Mode,
                    default_overrides: dict[str, Any] | None = None) -> None:
    """Add every descriptor applicable to `mode` to an argparse parser.
    `default_overrides` adjusts per-mode defaults (e.g. the ACDS listen port)
    without forking the descriptor."""
    overrides = default_overrides or {}
    for d in registry.descriptors(mode=mode):
        default = overrides.get(d.name, d.default)
        dest = d.name.replace("-", "_")
        if d.positional:
            # optional (e.g. --browse needs no address); callers validate
            parser.add_argument(dest, nargs="?", default=default, help=d.help)
        elif d.type is bool:
            parser.add_argument(f"--{d.name}", action="store_true",
                                default=bool(default), help=d.help)
        else:
            kw: dict[str, Any] = {
                "type": d.cli_type or d.type,
                "default": default,
                "help": d.help,
            }
            if d.choices and d.cli_type is None:
                kw["choices"] = list(d.choices)
            parser.add_argument(f"--{d.name}", **kw)


# ---------------------------------------------------------------------------
# The framework's registry (domains mirror lib/options/registry/*.c).


def _parse_wh(s: str) -> tuple[int, int]:
    """CLI converter for WxH sizes; rejects malformed/degenerate values."""
    import argparse

    w_s, sep, h_s = s.lower().partition("x")
    try:
        w, h = int(w_s), int(h_s)
    except ValueError:
        w = h = 0
    if not sep or w < 1 or h < 1 or w > 8192 or h > 8192:
        raise argparse.ArgumentTypeError(
            f"invalid size {s!r} (expected WxH, e.g. 640x480)")
    return w, h


def _parse_color_mode(s: str):
    """CLI converter: 'auto' -> None (detect); accepts both the friendly
    forms (none/16/256/truecolor) and the enum names (NONE/COLOR_16/...)."""
    from asciichat_tpu_torch.render.types import ColorLevel

    low = s.lower()
    if low == "auto":
        return None
    alias = {"none": "NONE", "16": "COLOR_16", "256": "COLOR_256",
             "truecolor": "TRUECOLOR"}
    name = alias.get(low, s.upper())
    try:
        return ColorLevel[name]
    except KeyError:
        import argparse

        raise argparse.ArgumentTypeError(
            f"invalid color mode {s!r} (auto/none/16/256/truecolor)"
        ) from None


def default_registry() -> OptionsRegistry:
    """THE option surface: every CLI flag of every mode is declared here and
    the argparse parsers are generated from it (apply_to_parser), so flags,
    TOML keys, completions, and help cannot drift
    (tests/test_subsystems.py asserts the bijection per mode)."""
    r = OptionsRegistry()
    add = r.add
    MC = Mode.MIRROR | Mode.CLIENT
    # display
    add("width", "display", int, 0, "output width in characters (0=auto)")
    add("height", "display", int, 0, "output height in characters (0=auto)")
    add("palette", "display", str, "standard",
        "palette name (standard/blocks/digital/minimal/cool) or custom chars")
    add("render-mode", "display", int, 0, "0=foreground 1=background 2=half-block",
        choices=(0, 1, 2))
    add("color-mode", "display", str, "auto",
        "color depth override (auto/none/16/256/truecolor)",
        choices=("auto", "none", "16", "256", "truecolor"),
        cli_type=_parse_color_mode)
    add("color-filter", "display", str, "none", "monochromatic tint filter")
    add("stretch", "display", bool, False, "ignore aspect ratio")
    add("show-fps", "display", bool, False, "FPS overlay")
    add("matrix", "display", bool, False, "digital rain overlay", modes=Mode.MIRROR)
    add("flip-x", "display", bool, False, "mirror horizontally", modes=MC)
    add("flip-y", "display", bool, False, "mirror vertically", modes=MC)
    add("snapshot", "display", bool, False, "render one frame and exit",
        modes=Mode.MIRROR)
    add("render-file", "display", str, None,
        "render to a video file (.y4m, or any format via ffmpeg)",
        modes=Mode.MIRROR)
    # media
    add("test-pattern", "media", bool, False, "synthetic webcam source", modes=MC)
    add("file", "media", str, None, "media file (image, or video via ffmpeg)",
        modes=MC)
    add("loop", "media", bool, False, "loop file playback", modes=MC)
    add("fps", "media", float, 30.0, "capture rate cap",
        validator=lambda v: 0 < v <= 144)
    add("stdin-size", "media", str, None,
        "read raw RGB24 frames from stdin at WxH (e.g. 640x480)", modes=MC,
        cli_type=_parse_wh)
    add("max-frames", "media", int, None, "stop after N frames",
        modes=MC | Mode.DISCOVERY)
    # network
    add("address", "network", str, None, "server address", modes=Mode.CLIENT,
        positional=True)
    add("port", "network", int, 27224, "TCP port",
        modes=Mode.SERVER | Mode.CLIENT | Mode.ACDS | Mode.DISCOVERY,
        validator=lambda v: 0 < v < 65536)
    add("host", "network", str, "0.0.0.0", "bind address",
        modes=Mode.SERVER | Mode.ACDS)
    add("compress", "network", int, 1, "zstd level 1-9", modes=Mode.SERVER,
        validator=lambda v: 1 <= v <= 9)
    add("no-compress", "network", bool, False,
        "advertise no-decompression (frames arrive uncompressed)",
        modes=Mode.CLIENT)
    add("no-reconnect", "network", bool, False, "disable auto-reconnect",
        modes=Mode.CLIENT)
    add("ws", "network", bool, False, "connect over WebSocket", modes=Mode.CLIENT)
    add("webrtc", "network", bool, False,
        "connect over a WebRTC DataChannel (dial the server's ws-port "
        "signaling endpoint; ICE + DTLS + SCTP)", modes=Mode.CLIENT)
    add("ws-port", "network", int, None,
        "also listen for WebSocket clients on this port", modes=Mode.SERVER)
    add("no-media", "network", bool, False, "view-only client", modes=Mode.CLIENT)
    add("mdns", "network", bool, False, "announce via mDNS on the LAN",
        modes=Mode.SERVER)
    add("browse", "network", bool, False,
        "list ascii-chat servers announced on the LAN (mDNS) and exit",
        modes=Mode.CLIENT)
    add("inspect-port", "network", int, None,
        "live-process inspector HTTP port (query-server analog)",
        modes=Mode.SERVER)
    add("update-check", "network", bool, False,
        "check for a newer release at startup (GitHub API; 7-day cache; "
        "never on by default)",
        modes=Mode.MIRROR | Mode.CLIENT | Mode.SERVER)
    add("status", "display", bool, False,
        "status screen with live log feed on this terminal",
        modes=Mode.SERVER)
    add("h265", "network", bool, False,
        "H.265 uplink when ffmpeg + server support allow (else raw RGB)",
        modes=Mode.CLIENT)
    # security
    add("encrypt", "security", bool, False,
        "X25519 + XSalsa20-Poly1305 encrypted session", modes=Mode.CLIENT)
    add("password", "security", str, None, "session password (Argon2id auth)",
        modes=Mode.SERVER | Mode.CLIENT)
    add("allowed-keys", "security", str, None,
        "require SSH-key client auth (ed25519): authorized_keys file, or "
        "forge specs fetched over HTTPS (github:USER / gitlab:USER, "
        "comma-separated)",
        modes=Mode.SERVER)
    add("ssh-key", "security", str, None,
        "OpenSSH private key file for client auth; implies --encrypt",
        modes=Mode.CLIENT)
    add("ssh-agent", "security", bool, False,
        "authenticate with the first ed25519 identity from ssh-agent; "
        "implies --encrypt", modes=Mode.CLIENT)
    add("gpg-keyring", "security", str, None,
        "GNUPGHOME of allowed client keys: require GPG auth", modes=Mode.SERVER)
    add("gpg-key", "security", str, None,
        "GPG key id/fingerprint to authenticate with ('default' = first "
        "secret key); implies --encrypt", modes=Mode.CLIENT)
    # audio
    add("audio", "audio", bool, False,
        "send/receive audio (mic via arecord, else 440Hz tone)",
        modes=Mode.CLIENT)
    add("tone-hz", "audio", float, None,
        "synthetic tone capture frequency (0 = silence); implies --audio "
        "(mirror: muxed into --render-file)",
        modes=Mode.MIRROR | Mode.CLIENT)
    add("audio-wav", "audio", str, None,
        "WAV file as the audio capture source; implies --audio "
        "(mirror: muxed into --render-file)",
        modes=Mode.MIRROR | Mode.CLIENT)
    add("audio-out", "audio", str, None,
        "write received mix to this raw-f32 file (default: speaker/null)",
        modes=Mode.CLIENT)
    add("audio-gain", "audio", float, 1.0, "capture gain applied before send",
        modes=Mode.CLIENT, validator=lambda v: 0 <= v <= 4)
    add("opus", "audio", bool, False,
        "Opus-compress audio (libopus via ctypes; raw PCM fallback)",
        modes=Mode.CLIENT)
    # discovery
    add("acds", "discovery", str, "127.0.0.1", "discovery service address",
        modes=Mode.DISCOVERY)
    add("acds-port", "discovery", int, 27225, "discovery service port",
        modes=Mode.DISCOVERY)
    add("join", "discovery", str, None,
        "session string to join (else create)", modes=Mode.DISCOVERY)
    add("advertise", "discovery", str, "127.0.0.1",
        "address to advertise as host", modes=Mode.DISCOVERY)
    add("stun", "discovery", str, None,
        "STUN server (host:port) for server-reflexive P2P candidates",
        modes=Mode.DISCOVERY)
    add("p2p-dtls", "discovery", str, "auto",
        "P2P channel security: auto (DTLS-SCTP DataChannels when OpenSSL "
        "present + peer advertises), on, or off (legacy secretbox stream)",
        modes=Mode.DISCOVERY)
    add("ring-interval", "discovery", float, None,
        "ring-consensus collection interval in seconds (default 60)",
        modes=Mode.DISCOVERY)
    add("view", "discovery", bool, False,
        "when creating, also view the session locally", modes=Mode.DISCOVERY)
    add("db", "discovery", str, ":memory:", "SQLite session database path",
        modes=Mode.ACDS)
    # config
    add("config", "config", str, None, "TOML config file")
    add("preset", "config", str, None, "named preset from the config file")
    # logging
    add("log-level", "log", str, "INFO", "log verbosity",
        choices=("DEV", "DEBUG", "INFO", "WARNING", "ERROR"))
    add("log-file", "log", str, None, "log file path (3MB rotation)")
    add("grep", "log", str, None, "regex filter applied to log messages")
    add("log-json", "log", bool, False, "JSON log sink")
    return r
