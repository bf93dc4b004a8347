"""ACIP control-payload structs + O(1) packet dispatch.

Wire formats follow the reference packed structs in network byte order:
- terminal_capabilities_packet_t (packet.h:1018-1054)
- size_message: {u16 width, u16 height}
- error message: {u32 code} + utf-8 text
Dispatch mirrors the reference's O(1) handler tables
(lib/network/acip/handlers.c:176,630): a dict from packet type to coroutine.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Awaitable, Callable

from asciichat_tpu_torch.net.packet import PacketType
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities

CAPS_STRUCT = struct.Struct(">IIIIHH32s32sBII64sBBBII")


@dataclasses.dataclass
class WireCapabilities:
    """Full client capability report (terminal_capabilities_packet_t)."""

    caps: TerminalCapabilities = dataclasses.field(default_factory=TerminalCapabilities)
    capabilities_mask: int = 0
    color_count: int = 16_777_216
    width: int = 80
    height: int = 24
    term_type: str = "xterm-256color"
    colorterm: str = "truecolor"
    detection_reliable: bool = True
    palette_type: int = 0  # PALETTE_STANDARD
    palette_custom: str = ""
    desired_fps: int = 60
    color_filter: int = 0
    codec_video: int = 0
    codec_audio: int = 0

    def pack(self) -> bytes:
        return CAPS_STRUCT.pack(
            self.capabilities_mask,
            int(self.caps.color_level) & 0xFFFFFFFF,
            self.color_count,
            int(self.caps.render_mode),
            self.width,
            self.height,
            self.term_type.encode()[:32],
            self.colorterm.encode()[:32],
            1 if self.detection_reliable else 0,
            1 if self.caps.utf8_support else 0,
            self.palette_type,
            self.palette_custom.encode()[:64],
            self.desired_fps,
            self.color_filter,
            1 if self.caps.wants_padding else 0,
            self.codec_video,
            self.codec_audio,
        )

    @staticmethod
    def unpack(buf: bytes) -> "WireCapabilities":
        if len(buf) < CAPS_STRUCT.size:
            raise ValueError(
                f"short CLIENT_CAPABILITIES payload ({len(buf)} bytes, "
                f"need {CAPS_STRUCT.size})")
        (mask, color_level, color_count, render_mode, w, h, term, colorterm,
         reliable, utf8, ptype, pcustom, fps, cfilter, padding, cv, ca) = (
            CAPS_STRUCT.unpack(buf[: CAPS_STRUCT.size])
        )
        if color_level >= 0x80000000:
            color_level -= 0x100000000  # AUTO = -1 round-trips through u32
        caps = TerminalCapabilities(
            color_level=ColorLevel(color_level),
            render_mode=RenderMode(render_mode),
            wants_padding=bool(padding),
            utf8_support=bool(utf8),
        )
        return WireCapabilities(
            caps=caps,
            capabilities_mask=mask,
            color_count=color_count,
            width=w,
            height=h,
            term_type=term.split(b"\0")[0].decode(errors="replace"),
            colorterm=colorterm.split(b"\0")[0].decode(errors="replace"),
            detection_reliable=bool(reliable),
            palette_type=ptype,
            palette_custom=pcustom.split(b"\0")[0].decode(errors="replace"),
            desired_fps=fps,
            color_filter=cfilter,
            codec_video=cv,
            codec_audio=ca,
        )


SIZE_STRUCT = struct.Struct(">HH")


def pack_size(width: int, height: int) -> bytes:
    return SIZE_STRUCT.pack(width, height)


def unpack_size(buf: bytes) -> tuple[int, int]:
    # short payloads raise ValueError, NOT struct.error: struct.error is a
    # bare Exception subclass that escapes every protocol-violation handler
    # (the server's bad-data disconnect and the client's reconnect loop
    # both catch ValueError)
    if len(buf) < SIZE_STRUCT.size:
        raise ValueError(f"short SIZE_MESSAGE payload ({len(buf)} bytes)")
    return SIZE_STRUCT.unpack(buf[: SIZE_STRUCT.size])


# On-wire ERROR_MESSAGE codes (the apps' shared vocabulary — distinct from
# utils.errors.ErrorCode, which is the INTERNAL errno-style enum; conflating
# the two rendered a codec refusal as 'out of memory')
class WireError:
    SERVER_FULL = 1
    ENCRYPTION_REQUIRED = 2
    CODEC_UNAVAILABLE = 3


def pack_error(code: int, message: str) -> bytes:
    return struct.pack(">I", code) + message.encode()


def unpack_error(buf: bytes) -> tuple[int, str]:
    if len(buf) < 4:
        raise ValueError(f"short ERROR_MESSAGE payload ({len(buf)} bytes)")
    (code,) = struct.unpack(">I", buf[:4])
    return code, buf[4:].decode(errors="replace")


Handler = Callable[..., Awaitable[None]]


class Dispatcher:
    """O(1) packet dispatch table (handlers.c pattern)."""

    def __init__(self):
        self._table: dict[int, Handler] = {}
        self.unknown_count = 0

    def on(self, ptype: PacketType):
        def deco(fn: Handler) -> Handler:
            self._table[int(ptype)] = fn
            return fn

        return deco

    def register(self, ptype: PacketType, fn: Handler) -> None:
        self._table[int(ptype)] = fn

    async def dispatch(self, ptype: int, payload: bytes, *ctx) -> bool:
        fn = self._table.get(ptype)
        if fn is None:
            self.unknown_count += 1
            return False
        await fn(payload, *ctx)
        return True
