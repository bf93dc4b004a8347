"""STUN (RFC 5389 subset): the binding messages ICE connectivity checks use.

Counterpart of the STUN/ICE machinery inside lib/network/webrtc/ (the
reference links libdatachannel/libjuice; this is an own implementation of
the public RFC): Binding request/success-response with XOR-MAPPED-ADDRESS,
USERNAME, MESSAGE-INTEGRITY (HMAC-SHA1 over the message with the ICE
password) and FINGERPRINT (CRC32 ^ 0x5354554e), which is exactly the subset
ICE-lite agents need for connectivity checks (RFC 8445 §7).

The port's copy of ``asciichat_tpu/net/stun.py``.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
import zlib

MAGIC_COOKIE = 0x2112A442
BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101

ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

# RFC 8445 §16.1: the role tie-breaker is ONE random 64-bit value per
# session — regenerating it per request makes a conforming peer's role-
# conflict resolution (487 handling) flap between retransmits
SESSION_TIEBREAKER = os.urandom(8)

HEADER = struct.Struct(">HHI12s")


class StunError(ValueError):
    pass


def _pad4(data: bytes) -> bytes:
    return data + b"\0" * (-len(data) % 4)


def new_transaction_id() -> bytes:
    return os.urandom(12)


def build(msg_type: int, txid: bytes, attrs: list[tuple[int, bytes]],
          password: bytes | None = None, fingerprint: bool = True) -> bytes:
    """Assemble a message; MESSAGE-INTEGRITY and FINGERPRINT are appended in
    that order, each computed over the message with the length field
    adjusted per RFC 5389 §15.4/§15.5."""
    body = b"".join(
        struct.pack(">HH", t, len(v)) + _pad4(v) for t, v in attrs
    )
    if password is not None:
        # integrity covers the header with length including the MI attribute
        hdr = HEADER.pack(msg_type, len(body) + 24, MAGIC_COOKIE, txid)
        mac = hmac.new(password, hdr + body, hashlib.sha1).digest()
        body += struct.pack(">HH", ATTR_MESSAGE_INTEGRITY, 20) + mac
    if fingerprint:
        hdr = HEADER.pack(msg_type, len(body) + 8, MAGIC_COOKIE, txid)
        fp = (zlib.crc32(hdr + body) & 0xFFFFFFFF) ^ 0x5354554E
        body += struct.pack(">HHI", ATTR_FINGERPRINT, 4, fp)
    return HEADER.pack(msg_type, len(body), MAGIC_COOKIE, txid) + body


def parse(data: bytes) -> tuple[int, bytes, dict[int, bytes]]:
    """-> (msg_type, txid, {attr: value}); raises StunError on malformed or
    non-STUN input."""
    if len(data) < 20:
        raise StunError("short STUN message")
    msg_type, length, cookie, txid = HEADER.unpack(data[:20])
    if cookie != MAGIC_COOKIE or len(data) < 20 + length:
        raise StunError("not a STUN message")
    attrs: dict[int, bytes] = {}
    at = 20
    end = 20 + length
    while at + 4 <= end:
        t, n = struct.unpack(">HH", data[at : at + 4])
        if at + 4 + n > end:
            # an attribute claiming bytes past the declared message end is
            # malformed input, not a short value to silently truncate
            raise StunError("STUN attribute overruns message")
        if t == ATTR_MESSAGE_INTEGRITY:
            # RFC 5389 §15.4: attributes after MESSAGE-INTEGRITY (except
            # FINGERPRINT) are NOT covered by the MAC and MUST be ignored —
            # and a duplicate must never overwrite the authenticated value
            # (verify_integrity only authenticates up to the MI boundary,
            # so a consumer of parse()+verify_integrity would otherwise
            # trust attacker-appended duplicates)
            attrs[t] = data[at + 4 : at + 4 + n]
            break
        if t not in attrs:  # first occurrence wins
            attrs[t] = data[at + 4 : at + 4 + n]
        at += 4 + n + (-n % 4)
    return msg_type, txid, attrs


def verify_integrity(data: bytes, password: bytes) -> bool:
    """Re-compute MESSAGE-INTEGRITY over the received bytes (RFC 5389 §15.4:
    length rewritten to end at the MI attribute; FINGERPRINT excluded)."""
    try:
        msg_type, length, cookie, txid = HEADER.unpack(data[:20])
    except struct.error:
        return False
    at = 20
    end = 20 + length
    while at + 4 <= end and at + 4 <= len(data):
        t, n = struct.unpack(">HH", data[at : at + 4])
        if t == ATTR_MESSAGE_INTEGRITY:
            mac = data[at + 4 : at + 4 + 20]
            covered_len = at + 24 - 20
            hdr = HEADER.pack(msg_type, covered_len, MAGIC_COOKIE, txid)
            want = hmac.new(password, hdr + data[20:at], hashlib.sha1).digest()
            return hmac.compare_digest(mac, want)
        at += 4 + n + (-n % 4)
    return False


def xor_mapped_address(addr: tuple[str, int]) -> bytes:
    """IPv4 XOR-MAPPED-ADDRESS value (RFC 5389 §15.2)."""
    ip, port = addr
    xport = port ^ (MAGIC_COOKIE >> 16)
    xip = struct.unpack(">I", socket.inet_aton(ip))[0] ^ MAGIC_COOKIE
    return struct.pack(">BBHI", 0, 0x01, xport, xip)


def parse_xor_mapped_address(value: bytes) -> tuple[str, int]:
    if len(value) < 8 or value[1] != 0x01:
        raise StunError("only IPv4 XOR-MAPPED-ADDRESS supported")
    _, _fam, xport, xip = struct.unpack(">BBHI", value[:8])
    port = xport ^ (MAGIC_COOKIE >> 16)
    ip = socket.inet_ntoa(struct.pack(">I", xip ^ MAGIC_COOKIE))
    return ip, port


def is_stun(data: bytes) -> bool:
    """Demultiplex STUN from application datagrams on a shared socket
    (RFC 7983: STUN first byte is 0-3 and the magic cookie matches)."""
    return (len(data) >= 20 and data[0] < 4
            and struct.unpack(">I", data[4:8])[0] == MAGIC_COOKIE)


def make_binding_request(txid: bytes, username: str, password: bytes,
                         controlling: bool = True,
                         tiebreaker: bytes | None = None) -> bytes:
    """Every request carries its role attribute (RFC 8445 §7.1.3):
    ICE-CONTROLLING + USE-CANDIDATE when controlling, ICE-CONTROLLED
    otherwise, both with the constant per-session tie-breaker."""
    tb = tiebreaker or SESSION_TIEBREAKER
    attrs = [
        (ATTR_USERNAME, username.encode()),
        (ATTR_PRIORITY, struct.pack(">I", 0x7E0000FF)),
    ]
    if controlling:
        attrs.append((ATTR_ICE_CONTROLLING, tb))
        attrs.append((ATTR_USE_CANDIDATE, b""))
    else:
        attrs.append((ATTR_ICE_CONTROLLED, tb))
    return build(BINDING_REQUEST, txid, attrs, password=password)


def make_binding_response(txid: bytes, peer_addr: tuple[str, int],
                          password: bytes) -> bytes:
    attrs = [(ATTR_XOR_MAPPED_ADDRESS, xor_mapped_address(peer_addr))]
    return build(BINDING_SUCCESS, txid, attrs, password=password)
