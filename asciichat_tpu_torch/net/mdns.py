"""Minimal mDNS announce/discover for LAN server discovery (--mdns).

The port's copy of ``asciichat_tpu/net/mdns.py`` (standard library only).

Parity with lib/network/mdns/{discovery,mdns}.c: the server announces
_asciichat._tcp.local on 224.0.0.251:5353 (PTR + SRV + TXT records); clients
query for the service type and collect responders. Dependency-free DNS
message encode/decode (only the record types mDNS service discovery needs).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time

MDNS_GROUP = "224.0.0.251"
MDNS_PORT = 5353
SERVICE = "_asciichat._tcp.local"

TYPE_PTR, TYPE_TXT, TYPE_SRV, TYPE_A = 12, 16, 33, 1
CLASS_IN = 1


def _encode_name(name: str) -> bytes:
    out = b""
    for label in name.strip(".").split("."):
        raw = label.encode()
        out += bytes([len(raw)]) + raw
    return out + b"\0"


def _decode_name(buf: bytes, off: int) -> tuple[str, int]:
    labels = []
    jumps = 0
    pos = off
    end = None
    while True:
        if pos >= len(buf):
            break
        length = buf[pos]
        if length == 0:
            pos += 1
            break
        if length & 0xC0 == 0xC0:  # compression pointer
            ptr = struct.unpack(">H", buf[pos : pos + 2])[0] & 0x3FFF
            if end is None:
                end = pos + 2
            pos = ptr
            jumps += 1
            if jumps > 20:
                break
            continue
        labels.append(buf[pos + 1 : pos + 1 + length].decode(errors="replace"))
        pos += 1 + length
    return ".".join(labels), (end if end is not None else pos)


def build_announcement(instance: str, port: int, txt: dict[str, str],
                       address: str) -> bytes:
    """Unsolicited mDNS response: PTR + SRV + TXT + A."""
    full = f"{instance}.{SERVICE}"
    header = struct.pack(">HHHHHH", 0, 0x8400, 0, 4, 0, 0)  # QR=1 AA=1

    def record(name, rtype, rdata, ttl=120):
        return (_encode_name(name) + struct.pack(">HHIH", rtype, CLASS_IN | 0x8000, ttl, len(rdata))
                + rdata)

    ptr = record(SERVICE, TYPE_PTR, _encode_name(full))
    srv = record(full, TYPE_SRV,
                 struct.pack(">HHH", 0, 0, port) + _encode_name(f"{instance}.local"))

    def txt_entry(k: str, v: str) -> bytes:
        # length prefix counts ENCODED bytes (multibyte UTF-8 values shifted
        # every following entry before); entries cap at the DNS 255-byte
        # character-string limit instead of raising from bytes([n])
        raw = f"{k}={v}".encode()[:255]
        return bytes([len(raw)]) + raw

    txt_data = b"".join(txt_entry(k, v) for k, v in txt.items()) or b"\0"
    txtr = record(full, TYPE_TXT, txt_data)
    a = record(f"{instance}.local", TYPE_A, socket.inet_aton(address))
    return header + ptr + srv + txtr + a


def build_query() -> bytes:
    header = struct.pack(">HHHHHH", 0, 0, 1, 0, 0, 0)
    return header + _encode_name(SERVICE) + struct.pack(">HH", TYPE_PTR, CLASS_IN)


@dataclasses.dataclass
class DiscoveredService:
    instance: str
    address: str
    port: int
    txt: dict[str, str]


def parse_response(buf: bytes, src_addr: str) -> DiscoveredService | None:
    """Records are associated BY NAME (SRV/TXT must carry the PTR target's
    name, the A record the SRV target host's) — a response carrying extra
    unrelated records can no longer cross-wire another service's port or
    address onto the returned instance."""
    try:
        _, flags, qd, an, ns, ar = struct.unpack(">HHHHHH", buf[:12])
        if not flags & 0x8000:
            return None
        off = 12
        for _ in range(qd):  # skip questions
            _, off = _decode_name(buf, off)
            off += 4
        ptr_target: str | None = None
        srv: dict[str, tuple[int, str]] = {}  # name -> (port, target host)
        txts: dict[str, dict[str, str]] = {}
        addrs: dict[str, str] = {}
        for _ in range(an + ns + ar):
            name, off = _decode_name(buf, off)
            rtype, _cls, _ttl, rdlen = struct.unpack(">HHIH", buf[off : off + 10])
            off += 10
            rdata = buf[off : off + rdlen]
            if rtype == TYPE_PTR and name == SERVICE:
                ptr_target, _ = _decode_name(buf, off)
            elif rtype == TYPE_SRV:
                _, _, port = struct.unpack(">HHH", rdata[:6])
                host, _ = _decode_name(buf, off + 6)
                srv[name] = (port, host)
            elif rtype == TYPE_TXT:
                txt: dict[str, str] = {}
                i = 0
                while i < len(rdata):
                    n = rdata[i]
                    entry = rdata[i + 1 : i + 1 + n].decode(errors="replace")
                    if "=" in entry:
                        k, v = entry.split("=", 1)
                        txt[k] = v
                    i += 1 + n
                txts[name] = txt
            elif rtype == TYPE_A and rdlen == 4:
                addrs[name] = socket.inet_ntoa(rdata)
            off += rdlen
        if not ptr_target or ptr_target not in srv:
            return None
        port, host = srv[ptr_target]
        if not port:
            return None
        # full instance name, not first-label truncation ("my.server" must
        # not collapse with "my.other" in discover()'s dedupe)
        suffix = "." + SERVICE
        instance = (ptr_target[: -len(suffix)]
                    if ptr_target.endswith(suffix) else ptr_target)
        # loopback in an A record is never a usable LAN target — the packet
        # source address is the ground truth then
        address = addrs.get(host, src_addr)
        if address.startswith("127."):
            address = src_addr
        return DiscoveredService(instance, address, port,
                                 txts.get(ptr_target, {}))
    except (struct.error, IndexError):
        pass
    return None


def _mdns_socket() -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("", MDNS_PORT))
    mreq = socket.inet_aton(MDNS_GROUP) + socket.inet_aton("0.0.0.0")
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 255)
    return sock


def _lan_address() -> str:
    """Outbound LAN IP (no packets sent — connect() on UDP only routes)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


class MdnsAnnouncer:
    """Server-side responder: announces on start + answers PTR queries."""

    def __init__(self, instance: str, port: int, txt: dict[str, str] | None = None,
                 address: str | None = None):
        # address defaults to the host's outbound LAN IP: announcing the
        # old 127.0.0.1 default made every REMOTE client that honored the A
        # record connect to itself — discovery's whole purpose defeated
        self.announcement = build_announcement(instance, port, txt or {},
                                               address or _lan_address())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        try:
            sock = _mdns_socket()
        except OSError:
            return  # multicast unavailable (containers): silently disabled
        sock.settimeout(0.5)
        sock.sendto(self.announcement, (MDNS_GROUP, MDNS_PORT))
        while not self._stop.is_set():
            try:
                buf, addr = sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            # answer PTR queries for our service type. The packet is
            # untrusted multicast: one malformed datagram must not kill the
            # responder thread (silent discovery DoS). Browsers batch
            # questions (avahi/Bonjour), so check EVERY question, not just
            # the first.
            try:
                if len(buf) > 12 and not struct.unpack(">H", buf[2:4])[0] & 0x8000:
                    qd = struct.unpack(">H", buf[4:6])[0]
                    off = 12
                    for _ in range(min(qd, 32)):
                        name, off = _decode_name(buf, off)
                        off += 4
                        if name == SERVICE:
                            sock.sendto(self.announcement,
                                        (MDNS_GROUP, MDNS_PORT))
                            break
            except (struct.error, IndexError):
                continue
        sock.close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


def discover(timeout: float = 2.0) -> list[DiscoveredService]:
    """Client-side one-shot discovery sweep."""
    try:
        sock = _mdns_socket()
    except OSError:
        return []
    sock.settimeout(0.3)
    sock.sendto(build_query(), (MDNS_GROUP, MDNS_PORT))
    # dedupe by (instance, address, port): N servers announcing the same
    # instance name (the default is shared) must all stay visible
    found: dict[tuple, DiscoveredService] = {}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            buf, addr = sock.recvfrom(4096)
        except socket.timeout:
            continue
        except OSError:
            break
        svc = parse_response(buf, addr[0])
        if svc:
            found[(svc.instance, svc.address, svc.port)] = svc
    sock.close()
    return list(found.values())
