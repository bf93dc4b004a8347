"""ACIP packet framing: wire-compatible with the reference protocol.

Header (22 bytes, packed, network byte order — packet.h:596-610,
packet.c:300-304):
    u64 magic (0xA5C11C4A1) | u16 type | u32 length | u32 crc32c(payload) |
    u32 client_id (always 0 on send)

Packet types: packet.h:286-470 (crypto 1000s, messages 2000s, media 3000s,
audio 4000s, control 5000s, ACDS/consensus 6000s).

Payload headers (also network byte order): ascii_frame_packet_t (24 B,
packet.h:848-862), image_frame_packet_t (24 B, packet.h:876-891),
audio_batch_packet_t. CRC is CRC32-C (Castagnoli, crc32.c:171-189).

Compression policy (packet.c:441-476, compression.h:58-61): zstd level 1-9,
only for payloads >= 1024 B whose compressed form is < 80% of the original.
"""

from __future__ import annotations

import ctypes
import enum
import struct
import time

MAGIC = 0xA5C11C4A1
HEADER = struct.Struct(">QHIII")  # magic, type, length, crc32, client_id
HEADER_SIZE = HEADER.size  # 22
MAX_PACKET_SIZE = 5 * 1024 * 1024  # packet.h:113

COMPRESSION_MIN_SIZE = 1024  # compression.h:61
COMPRESSION_RATIO_THRESHOLD = 0.8  # compression.h:58

# Frame flags (common/protocol_constants.h:59-68)
FRAME_FLAG_HAS_COLOR = 0x01
FRAME_FLAG_IS_COMPRESSED = 0x02
FRAME_FLAG_RLE_COMPRESSED = 0x04
FRAME_FLAG_IS_STRETCHED = 0x08


class PacketType(enum.IntEnum):
    """packet_type_t (packet.h:286-470)."""

    PROTOCOL_VERSION = 1
    # crypto (1000s)
    CRYPTO_CLIENT_HELLO = 1000
    CRYPTO_CAPABILITIES = 1100
    CRYPTO_PARAMETERS = 1101
    CRYPTO_KEY_EXCHANGE_INIT = 1102
    CRYPTO_KEY_EXCHANGE_RESP = 1103
    CRYPTO_AUTH_CHALLENGE = 1104
    CRYPTO_AUTH_RESPONSE = 1105
    CRYPTO_AUTH_FAILED = 1106
    CRYPTO_SERVER_AUTH_RESP = 1107
    CRYPTO_HANDSHAKE_COMPLETE = 1108
    CRYPTO_NO_ENCRYPTION = 1109
    ENCRYPTED = 1200
    CRYPTO_REKEY_REQUEST = 1201
    CRYPTO_REKEY_RESPONSE = 1202
    CRYPTO_REKEY_COMPLETE = 1203
    # messages (2000s)
    SIZE_MESSAGE = 2000
    AUDIO_MESSAGE = 2001  # vestigial in the reference too: validated in packet.c:173 but no handler exists anywhere
    TEXT_MESSAGE = 2002
    ERROR_MESSAGE = 2003
    REMOTE_LOG = 2004
    # media (3000s)
    ASCII_FRAME = 3000
    IMAGE_FRAME = 3001
    IMAGE_FRAME_H265 = 3002
    # audio (4000s)
    AUDIO_BATCH = 4000
    AUDIO_OPUS_BATCH = 4001
    # control (5000s)
    CLIENT_CAPABILITIES = 5000
    PING = 5001
    PONG = 5002
    CLIENT_JOIN = 5003
    CLIENT_LEAVE = 5004
    STREAM_START = 5005
    STREAM_STOP = 5006
    CLEAR_CONSOLE = 5007
    SERVER_STATE = 5008
    # ACDS discovery (6000s)
    ACIP_SESSION_CREATE = 6000
    ACIP_SESSION_CREATED = 6001
    ACIP_SESSION_LOOKUP = 6002
    ACIP_SESSION_INFO = 6003
    ACIP_SESSION_JOIN = 6004
    ACIP_SESSION_JOINED = 6005
    ACIP_SESSION_LEAVE = 6006
    ACIP_SESSION_END = 6007
    ACIP_SESSION_RECONNECT = 6008
    ACIP_WEBRTC_SDP = 6009
    ACIP_WEBRTC_ICE = 6010
    # TURN-role data relay: when ICE connectivity fails, SecureP2PChannel
    # segments (still end-to-end encrypted) ride the signaling relay
    # (parallel_connect.c:1-321 direct -> ICE -> TURN ladder, last rung)
    ACIP_WEBRTC_RELAY = 6011
    ACIP_STRING_RESERVE = 6020
    ACIP_STRING_RESERVED = 6021
    ACIP_STRING_RENEW = 6022
    ACIP_STRING_RELEASE = 6023
    ACIP_PARTICIPANT_LIST = 6050
    ACIP_RING_COLLECT = 6051
    ACIP_NETWORK_QUALITY = 6060
    ACIP_HOST_ANNOUNCEMENT = 6061
    ACIP_HOST_DESIGNATED = 6062
    ACIP_SETTINGS_SYNC = 6063
    ACIP_SETTINGS_ACK = 6064
    # server->client greeting carrying the per-connection registration
    # nonce (anti-replay channel binding for signed create/join bodies)
    ACIP_ACDS_HELLO = 6070


# Every ACDS subprotocol payload (6000-6099) travels Ed25519-signed (the
# reference signs its packed ACDS structs, acds.h). ONE definition: the
# server gate (apps/acds.py) and the client signer (apps/discovery.py)
# must never drift on what counts as signed.
ACDS_SIGNED_RANGE = range(6000, 6100)


# ---------------------------------------------------------------------------
# CRC32-C: native fast path, pure-Python fallback

_CRC_TABLE: list[int] | None = None


def _crc32c_py(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_native_crc = None


def crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli) — matches asciichat_crc32 (crc32.c)."""
    global _native_crc
    if _native_crc is None:
        try:
            from asciichat_tpu_torch.runtime.kernel_build import native_lib

            lib = native_lib("runtime")
            lib.ac_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.ac_crc32c.restype = ctypes.c_uint32
            _native_crc = lib.ac_crc32c
        except Exception:
            _native_crc = False
    if _native_crc:
        return _native_crc(data, len(data))
    return _crc32c_py(data)


# ---------------------------------------------------------------------------
# Header framing


def pack_packet(ptype: int, payload: bytes = b"", client_id: int = 0) -> bytes:
    if len(payload) > MAX_PACKET_SIZE:
        raise ValueError(f"packet too large: {len(payload)} > {MAX_PACKET_SIZE}")
    crc = crc32c(payload) if payload else 0
    return HEADER.pack(MAGIC, ptype, len(payload), crc, client_id) + payload


def unpack_header(buf: bytes) -> tuple[int, int, int, int]:
    """-> (type, length, crc32, client_id); raises ValueError on bad input."""
    if len(buf) < HEADER_SIZE:
        raise ValueError(f"short packet header: {len(buf)} < {HEADER_SIZE}")
    magic, ptype, length, crc, client_id = HEADER.unpack(buf[:HEADER_SIZE])
    if magic != MAGIC:
        raise ValueError(f"bad packet magic 0x{magic:x}")
    if length > MAX_PACKET_SIZE:
        raise ValueError(f"packet length {length} exceeds max")
    return ptype, length, crc, client_id


def verify_payload(payload: bytes, crc: int) -> bool:
    return not payload or crc32c(payload) == crc


# ---------------------------------------------------------------------------
# Compression policy (packet.c:441-476)

_zstd_c = None
_zstd_d = None


def _zstd(level: int = 1):
    global _zstd_c, _zstd_d
    import zstandard

    if _zstd_c is None or _zstd_c[0] != level:
        _zstd_c = (level, zstandard.ZstdCompressor(level=level))
    if _zstd_d is None:
        _zstd_d = zstandard.ZstdDecompressor()
    return _zstd_c[1], _zstd_d


def maybe_compress(payload: bytes, level: int = 1) -> tuple[bytes, bool]:
    """zstd-compress when >= 1 KB and the result is < 80% of the original."""
    if len(payload) < COMPRESSION_MIN_SIZE:
        return payload, False
    comp, _ = _zstd(level)
    out = comp.compress(payload)
    if len(out) < COMPRESSION_RATIO_THRESHOLD * len(payload):
        return out, True
    return payload, False


def decompress(payload: bytes, original_size: int) -> bytes:
    """Bounded decompress with the bad-data ValueError contract.

    python-zstandard IGNORES max_output_size whenever the frame header
    embeds a content size (verified: a 3 KB frame declaring 100 MB
    decompresses in full past a 1000-byte cap) — so an attacker-declared
    multi-GB size would be allocated and filled before any length check: a
    remote unauthenticated OOM. Check the DECLARED size against the cap
    first; unknown-size (streaming) frames are safely capped by
    max_output_size. ZstdError converts to ValueError so corrupt frames
    take the protocol-violation disconnect path, not an unhandled task
    exception."""
    import zstandard

    _, dec = _zstd()
    try:
        declared = zstandard.get_frame_parameters(payload).content_size
        if (declared not in (zstandard.CONTENTSIZE_UNKNOWN,
                             zstandard.CONTENTSIZE_ERROR)
                and declared > original_size):
            raise ValueError(
                f"zstd declared size {declared} exceeds cap {original_size}")
        return dec.decompress(payload, max_output_size=original_size)
    except zstandard.ZstdError as e:
        raise ValueError(f"zstd decompress failed: {e}") from None


# ---------------------------------------------------------------------------
# Payload structs (network byte order)

ASCII_FRAME_HDR = struct.Struct(">IIIIII")  # w, h, orig, comp, crc, flags
IMAGE_FRAME_HDR = struct.Struct(">IIIIII")  # w, h, fmt, comp, crc, ts
AUDIO_BATCH_HDR = struct.Struct(">IIII")  # batch_count, total_samples, rate, ch

PIXEL_FORMAT_RGB24 = 0
PIXEL_FORMAT_RGBA32 = 1
PIXEL_FORMAT_BGR24 = 2
PIXEL_FORMAT_HEVC = 3  # IMAGE_FRAME_H265 payload: one Annex-B access unit


def pack_ascii_frame(
    frame: bytes, width: int, height: int, compress: bool = True, level: int = 1
) -> bytes:
    """ascii_frame_packet_t + data (acip server.c:190-240 + compression)."""
    crc = crc32c(frame)
    flags = 0
    data, compressed = (maybe_compress(frame, level) if compress else (frame, False))
    if compressed:
        flags |= FRAME_FLAG_IS_COMPRESSED
    hdr = ASCII_FRAME_HDR.pack(
        width, height, len(frame), len(data) if compressed else 0, crc, flags
    )
    return hdr + data


MAX_DECOMPRESSED_SIZE = 64 * 1024 * 1024  # decompression-bomb guard


def unpack_ascii_frame(payload: bytes) -> tuple[bytes, int, int, int]:
    """-> (frame_bytes, width, height, flags); verifies CRC of the original."""
    if len(payload) < ASCII_FRAME_HDR.size:
        raise ValueError("short ascii frame header")
    w, h, orig, comp, crc, flags = ASCII_FRAME_HDR.unpack(payload[: ASCII_FRAME_HDR.size])
    if orig > MAX_DECOMPRESSED_SIZE:
        raise ValueError(f"ascii frame original_size {orig} exceeds cap")
    body = payload[ASCII_FRAME_HDR.size :]
    frame = decompress(body, orig) if comp else body
    if len(frame) != orig:
        raise ValueError(f"frame size mismatch: {len(frame)} != {orig}")
    if crc32c(frame) != crc:
        raise ValueError("ascii frame CRC mismatch")
    return frame, w, h, flags


def pack_image_frame(
    pixels: bytes, width: int, height: int, pixel_format: int = PIXEL_FORMAT_RGB24,
    compress: bool = False, level: int = 1,
) -> bytes:
    crc = crc32c(pixels)
    data, compressed = (maybe_compress(pixels, level) if compress else (pixels, False))
    ts = int(time.time() * 1000) & 0xFFFFFFFF
    hdr = IMAGE_FRAME_HDR.pack(
        width, height, pixel_format, len(data) if compressed else 0, crc, ts
    )
    return hdr + data


def unpack_image_frame(payload: bytes) -> tuple[bytes, int, int, int]:
    """-> (pixels, width, height, pixel_format)."""
    if len(payload) < IMAGE_FRAME_HDR.size:
        raise ValueError("short image frame header")
    w, h, fmt, comp, crc, _ts = IMAGE_FRAME_HDR.unpack(payload[: IMAGE_FRAME_HDR.size])
    if w > 10000 or h > 10000:  # reference dimension sanity (ascii.c:204)
        raise ValueError(f"image dimensions {w}x{h} exceed sanity bounds")
    bpp = 4 if fmt == PIXEL_FORMAT_RGBA32 else 3  # bound by the DECLARED format
    if w * h * bpp > MAX_DECOMPRESSED_SIZE:
        raise ValueError(f"image {w}x{h} exceeds decompression cap")
    body = payload[IMAGE_FRAME_HDR.size :]
    pixels = decompress(body, w * h * bpp + 64) if comp else body
    if crc32c(pixels) != crc:
        raise ValueError("image frame CRC mismatch")
    return pixels, w, h, fmt


def pack_audio_batch(samples: bytes, num_samples: int, batch_count: int,
                     sample_rate: int = 48000, channels: int = 1) -> bytes:
    return AUDIO_BATCH_HDR.pack(batch_count, num_samples, sample_rate, channels) + samples


def unpack_audio_batch(payload: bytes) -> tuple[bytes, int, int, int, int]:
    if len(payload) < AUDIO_BATCH_HDR.size:
        # keep the ValueError bad-data contract (struct.error would escape
        # the callers' protocol-violation handlers)
        raise ValueError("short audio batch header")
    bc, total, rate, ch = AUDIO_BATCH_HDR.unpack(payload[: AUDIO_BATCH_HDR.size])
    return payload[AUDIO_BATCH_HDR.size :], bc, total, rate, ch
