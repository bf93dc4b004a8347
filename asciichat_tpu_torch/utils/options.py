"""Options system: domain registry + TOML config + lock-free snapshots +
generated help/completions.

Copied from ``asciichat_tpu/utils/options.py`` (the reference's lib/options/,
SURVEY §2c):
- single-source registry of descriptors grouped by domain with per-mode
  bitmasks (lib/options/registry/*.c)
- builder API generating the argparse surface (lib/options/builder/)
- TOML config files + named presets (lib/options/config/config.c), which
  ``apps/main.py`` layers under the command line (``--config``/``--preset``)
- RCU-published immutable snapshots read lock-free from hot threads
  (lib/options/rcu.c, GET_OPTION()): here an atomically-swapped frozen
  namespace — Python reference assignment is atomic, readers never lock
- generated shell completions + manpage text (lib/options/ generators),
  byte for byte the JAX package's (``completions``, ``manpage``)
"""

from __future__ import annotations

import dataclasses
import enum
import tomllib
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
    # argparse-surface metadata (builder API analog, lib/options/builder/):
    cli_type: Callable[[str], Any] | None = None  # CLI string converter
    positional: bool = False  # bare argument instead of --flag

    def validate(self, value: Any) -> Any:
        if value is None:
            # programmatic reset (publish(option=None)): None always means
            # "unset" — str(None) would store the literal "None" and
            # int(None) would raise despite None being a registered default
            return None
        if self.cli_type is not None:
            # the CLI converter is the string codec AND validator for EVERY
            # string source: argparse applies it on the command line
            # (build_parser hands argparse cli_type and withholds choices),
            # and TOML/publish strings must take the same path — a
            # config-file stdin-size otherwise stays a raw string and
            # StdinSource(*"640x480") explodes downstream. Choices on such
            # descriptors document the RAW strings, so they are not checked
            # against the converted value.
            # plain scalars (TOML `color-mode = 16` is a natural mistake for
            # "16") are stringified through the converter too — only already-
            # converted values (tuples, enums from the argparse path) pass
            # through. Exact type check: ColorLevel subclasses int and must
            # NOT be re-stringified.
            if type(value) in (str, int, float):
                try:
                    value = self.cli_type(str(value))
                except ValueError:
                    raise
                except Exception as e:  # argparse.ArgumentTypeError etc.
                    raise ValueError(f"--{self.name}: {e}") from None
            return value if self.validator is None or self.validator(value) \
                else self._invalid(value)
        if self.type is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        value = self.type(value)
        if self.choices and value not in self.choices:
            raise ValueError(f"--{self.name}: {value!r} not in {self.choices}")
        if self.validator and not self.validator(value):
            raise ValueError(f"--{self.name}: invalid value {value!r}")
        return value

    def _invalid(self, value: Any):
        raise ValueError(f"--{self.name}: invalid value {value!r}")


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

    def defaults(self) -> dict[str, Any]:
        return {d.name: d.default for d in self._descriptors.values()}

    def __contains__(self, name: str) -> bool:
        return name in self._descriptors

    def __getitem__(self, name: str) -> OptionDescriptor:
        return self._descriptors[name]


class FrozenOptions:
    """Immutable snapshot; attribute reads are the GET_OPTION() analog."""

    __slots__ = ("_values",)

    def __init__(self, values: dict[str, Any]):
        object.__setattr__(self, "_values", dict(values))

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name.replace("_", "-")]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self._values[name]

    def __setattr__(self, name, value):
        raise AttributeError("options snapshots are immutable; use publish()")

    def as_dict(self) -> dict[str, Any]:
        return dict(self._values)


class OptionsStore:
    """Atomically-swapped current snapshot (RCU publish analog)."""

    def __init__(self, registry: OptionsRegistry):
        self.registry = registry
        self._current = FrozenOptions(registry.defaults())

    @property
    def current(self) -> FrozenOptions:
        return self._current  # single reference read: lock-free for readers

    def publish(self, **overrides: Any) -> FrozenOptions:
        values = self._current.as_dict()
        for k, v in overrides.items():
            key = k.replace("_", "-")
            if key not in self.registry:
                raise KeyError(f"unknown option {key!r}")
            values[key] = self.registry[key].validate(v)
        snap = FrozenOptions(values)
        self._current = snap
        return snap

    def load_toml(self, path: str, preset: str | None = None) -> FrozenOptions:
        """[domain] tables + optional [preset.<name>] overlays
        (lib/options/config/config.c semantics)."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        overrides: dict[str, Any] = {}

        def absorb(table: dict) -> None:
            for dom, section in table.items():
                if dom == "preset":
                    continue
                if not isinstance(section, dict):
                    # top-level bare key — unknown names must fail loudly
                    # like their in-table counterparts (a typo'd `pasword`
                    # silently dropped means an unauthenticated server)
                    if dom not in self.registry:
                        raise KeyError(f"unknown option {dom!r} in {path}")
                    overrides[dom] = section
                    continue
                for key, value in section.items():
                    name = key if key in self.registry else f"{dom}-{key}"
                    if name in self.registry:
                        overrides[name] = value
                    else:
                        raise KeyError(f"unknown option {dom}.{key} in {path}")

        absorb(data)
        if preset:
            presets = data.get("preset", {})
            if preset not in presets:
                raise KeyError(f"no preset {preset!r} in {path}")
            absorb(presets[preset])
        # which option names the FILE actually set — config layering must
        # only apply those, never registry defaults riding in the snapshot
        # (a default 'address'/'port' would clobber CLI positionals and
        # per-mode argparse defaults)
        self.last_toml_keys = frozenset(overrides)
        return self.publish(**{k.replace("-", "_"): v for k, v in overrides.items()})


# ---------------------------------------------------------------------------
# Generators (argparse surface / help / completions), from the registry
# single source of truth (lib/options/builder/builder.c analog: the CLI is
# GENERATED from descriptors so flags, TOML keys, completions and help
# cannot drift).


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


def generate_help(registry: OptionsRegistry, mode: Mode) -> str:
    out = []
    domains: dict[str, list[OptionDescriptor]] = {}
    for d in registry.descriptors(mode=mode):
        domains.setdefault(d.domain, []).append(d)
    for dom in sorted(domains):
        out.append(f"{dom} options:")
        for d in sorted(domains[dom], key=lambda x: x.name):
            choices = f" ({'/'.join(map(str, d.choices))})" if d.choices else ""
            out.append(f"  --{d.name:<24}{d.help}{choices} [default: {d.default}]")
        out.append("")
    return "\n".join(out)


def generate_completions(registry: OptionsRegistry, shell: str, prog: str = "asciichat-tpu") -> str:
    names = sorted(f"--{d.name}" for d in registry.descriptors())
    if shell == "bash":
        return (
            f"_{prog.replace('-', '_')}() {{\n"
            f"  COMPREPLY=( $(compgen -W \"{' '.join(names)}\" -- \"${{COMP_WORDS[COMP_CWORD]}}\") )\n"
            f"}}\ncomplete -F _{prog.replace('-', '_')} {prog}\n"
        )
    if shell == "zsh":
        # help text is interpolated into a single-quoted _arguments spec:
        # apostrophes ('\'' splice) and square brackets (spec delimiters)
        # must be escaped or ONE flag's help breaks every completion
        def zq(s: str) -> str:
            return (s.replace("'", "'\\''")
                     .replace("[", "\\[").replace("]", "\\]"))

        args = "\n  ".join(f"'{n}[{zq(registry[n[2:]].help)}]'" for n in names)
        return f"#compdef {prog}\n_arguments \\\n  {args}\n"
    if shell == "fish":
        # fish single quotes: backslash-escape embedded ' and \
        def fq(s: str) -> str:
            return s.replace("\\", "\\\\").replace("'", "\\'")

        return "\n".join(
            f"complete -c {prog} -l {d.name} -d '{fq(d.help)}'"
            for d in sorted(registry.descriptors(), key=lambda x: x.name)
        )
    if shell == "pwsh":
        words = ", ".join(f"'--{d.name}'" for d in
                         sorted(registry.descriptors(), key=lambda x: x.name))
        return (
            f"Register-ArgumentCompleter -Native -CommandName {prog} "
            "-ScriptBlock {\n"
            "  param($wordToComplete, $commandAst, $cursorPosition)\n"
            f"  @({words}) | Where-Object {{ $_ -like \"$wordToComplete*\" }} |\n"
            "    ForEach-Object { [System.Management.Automation.CompletionResult]::new($_) }\n"
            "}\n"
        )
    raise ValueError(f"unknown shell {shell!r}")


def generate_manpage(registry: OptionsRegistry, prog: str = "asciichat-tpu") -> str:
    """troff man page from the registry (the reference's manpage generator
    role, lib/options/ generators)."""
    import time as _time

    out = [
        f'.TH {prog.upper()} 1 "{_time.strftime("%Y-%m-%d")}" "{prog}" '
        '"User Commands"',
        ".SH NAME",
        f"{prog} \\- TPU-native terminal video chat",
        ".SH SYNOPSIS",
        f".B {prog}",
        ".I mode",
        "[\\fIOPTIONS\\fR]",
        ".SH MODES",
        "mirror, server, client, discovery-service, discovery, bench, "
        "strings, completions",
        ".SH OPTIONS",
    ]
    domains: dict[str, list[OptionDescriptor]] = {}
    for d in registry.descriptors():
        domains.setdefault(d.domain, []).append(d)
    for dom in sorted(domains):
        out.append(f".SS {dom}")
        for d in sorted(domains[dom], key=lambda x: x.name):
            out.append(".TP")
            arg = "" if d.type is bool else f" \\fI{d.type.__name__.upper()}\\fR"
            out.append(f"\\fB--{d.name}\\fR{arg}")
            # identity checks: `0 in (None, False)` is True (0 == False),
            # which hid the 0=auto defaults of width/height/render-mode
            extra = ("" if d.default is None or d.default is False
                     else f" (default: {d.default})")
            out.append(d.help.replace("-", "\\-") + extra)
    return "\n".join(out) + "\n"


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
