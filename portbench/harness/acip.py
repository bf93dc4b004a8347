"""The ASCII_FRAME payload, read by the benchmark itself.

The layout is the protocol's ascii_frame_packet_t (packet.h:848-862, as the
port's net/packet.py packs it): six big-endian u32, the terminal's width and
height, the frame's length, its compressed length (0 where it is sent as it
is), the frame's CRC32-C and the flags (0x02: compressed), then the frame.
CRC32-C is the Castagnoli CRC of crc32.c:171-189 (reflected polynomial
0x82F63B78, initial and final value 0xFFFFFFFF).
"""

from __future__ import annotations

import struct

HEADER = struct.Struct(">IIIIII")
COMPRESSED = 0x02


def _table() -> list[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


TABLE = _table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, TABLE
    for byte in data:
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def header(frame: bytes, width: int, height: int) -> bytes:
    """The header an uncompressed payload of ``frame`` carries."""
    return HEADER.pack(width, height, len(frame), 0, crc32c(frame), 0)


def unpack(payload: bytes) -> tuple[int, int, int, bytes]:
    """(width, height, CRC32-C, frame) of an uncompressed payload; ValueError
    where the header says compressed or gives another length than the
    frame's. The CRC is returned as the header states it, not checked."""
    if len(payload) < HEADER.size:
        raise ValueError(f"payload of {len(payload)} bytes: shorter than its header")
    width, height, length, packed, crc, flags = HEADER.unpack_from(payload)
    frame = payload[HEADER.size:]
    if packed or flags & COMPRESSED:
        raise ValueError("a compressed frame, where the receiver asked for none")
    if len(frame) != length:
        raise ValueError(f"a frame of {len(frame)} bytes under a header of {length}")
    return width, height, crc, frame
