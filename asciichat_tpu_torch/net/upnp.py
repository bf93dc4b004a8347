"""NAT traversal: UPnP-IGD port mapping + NAT-PMP.

Counterpart of lib/network/nat/upnp.c: open an external port on the home
router so the P2P host candidates (net/webrtc.py) are reachable. Two
protocols, tried in order:

- UPnP IGD: SSDP M-SEARCH discovery (multicast 239.255.255.250:1900) ->
  device-description XML -> WAN(IP|PPP)Connection control URL -> SOAP
  AddPortMapping / DeletePortMapping / GetExternalIPAddress.
- NAT-PMP (RFC 6886): UDP to the default gateway on port 5351, opcode 1/2.

Everything network-touching takes explicit target overrides so the fake
router in tests drives the exact same code paths (this environment has no
real router; the reference gates the same way in CI).

The port's copy of ``asciichat_tpu/net/upnp.py``.
"""

from __future__ import annotations

import re
import socket
import struct
import time
import urllib.request
from urllib.parse import urljoin

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)
NATPMP_PORT = 5351


class NatError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# UPnP IGD


def ssdp_discover(timeout: float = 2.0, target=None) -> str:
    """-> LOCATION URL of an IGD device description (SSDP M-SEARCH)."""
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        "MX: 2\r\n"
        f"ST: {SSDP_ST}\r\n\r\n"
    ).encode()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(msg, target or SSDP_ADDR)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                data, _ = s.recvfrom(4096)
            except socket.timeout:
                break
            m = re.search(rb"(?im)^location:\s*(\S+)", data)
            if m:
                return m.group(1).decode()
        raise NatError("no IGD answered SSDP discovery")
    finally:
        s.close()


def _find_control_url(description_url: str) -> tuple[str, str]:
    """-> (control_url, service_type) from the device description XML."""
    # LOCATION comes from UNAUTHENTICATED multicast: any LAN host can answer
    # first. urllib would happily open file:// (local file read) or any
    # attacker-chosen URL — restrict to http(s).
    if not description_url.lower().startswith(("http://", "https://")):
        raise NatError(f"refusing non-http IGD location {description_url!r}")
    with urllib.request.urlopen(description_url, timeout=5) as r:
        xml = r.read().decode(errors="replace")
    for service_type in WAN_SERVICES:
        # tolerate attribute/namespace noise: regex over the service block
        pattern = (
            r"<serviceType>\s*" + re.escape(service_type)
            + r"\s*</serviceType>.*?<controlURL>\s*([^<]+?)\s*</controlURL>"
        )
        m = re.search(pattern, xml, re.S)
        if m:
            return urljoin(description_url, m.group(1)), service_type
    raise NatError("IGD has no WAN(IP|PPP)Connection service")


def _soap(control_url: str, service_type: str, action: str,
          args: dict[str, str]) -> str:
    from xml.sax.saxutils import escape

    # escape values: a description like "Tom & Jerry <chat>" is otherwise
    # malformed XML (router rejects) and a crafted one could inject sibling
    # SOAP arguments
    body = "".join(f"<{k}>{escape(v)}</{k}>" for k, v in args.items())
    envelope = (
        '<?xml version="1.0"?>'
        '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
        's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
        f'<s:Body><u:{action} xmlns:u="{service_type}">{body}</u:{action}>'
        "</s:Body></s:Envelope>"
    ).encode()
    req = urllib.request.Request(
        control_url, data=envelope,
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{service_type}#{action}"',
        },
    )
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.read().decode(errors="replace")


class UpnpGateway:
    """One discovered IGD; add/delete mappings, query the external IP."""

    def __init__(self, description_url: str):
        self.control_url, self.service_type = _find_control_url(description_url)

    @staticmethod
    def discover(timeout: float = 2.0, target=None) -> "UpnpGateway":
        return UpnpGateway(ssdp_discover(timeout, target=target))

    def add_port_mapping(self, external_port: int, internal_port: int,
                         internal_ip: str, protocol: str = "TCP",
                         description: str = "ascii-chat",
                         lease_s: int = 3600) -> None:
        self._soap_checked("AddPortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
            "NewInternalPort": str(internal_port),
            "NewInternalClient": internal_ip,
            "NewEnabled": "1",
            "NewPortMappingDescription": description,
            "NewLeaseDuration": str(lease_s),
        })

    def delete_port_mapping(self, external_port: int,
                            protocol: str = "TCP") -> None:
        self._soap_checked("DeletePortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": str(external_port),
            "NewProtocol": protocol,
        })

    def external_ip(self) -> str:
        resp = self._soap_checked("GetExternalIPAddress", {})
        m = re.search(r"<NewExternalIPAddress>([^<]+)<", resp)
        if not m:
            raise NatError("no external IP in IGD response")
        return m.group(1)

    def _soap_checked(self, action: str, args: dict[str, str]) -> str:
        try:
            return _soap(self.control_url, self.service_type, action, args)
        except urllib.request.HTTPError as e:  # type: ignore[attr-defined]
            raise NatError(f"{action} failed: HTTP {e.code}") from None
        except OSError as e:
            raise NatError(f"{action} failed: {e}") from None


# ---------------------------------------------------------------------------
# NAT-PMP (RFC 6886)


def natpmp_map(gateway_ip: str, internal_port: int, external_port: int,
               protocol: str = "tcp", lease_s: int = 3600,
               timeout: float = 1.0, gateway_port: int = NATPMP_PORT,
) -> tuple[int, int]:
    """-> (mapped_external_port, lease_s). opcode 1=UDP 2=TCP (RFC 6886 §3.3)."""
    opcode = 2 if protocol.lower() == "tcp" else 1
    req = struct.pack(">BBHHHI", 0, opcode, 0, internal_port, external_port,
                      lease_s)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(req, (gateway_ip, gateway_port))
        data, _ = s.recvfrom(64)
    except socket.timeout:
        raise NatError("NAT-PMP gateway did not answer") from None
    except OSError as e:
        # ICMP port-unreachable surfaces as ConnectionRefusedError on the
        # recvfrom — "gateway has no NAT-PMP" is a NatError like the rest of
        # the contract, not a raw OSError past open_external_port's callers
        raise NatError(f"NAT-PMP unavailable: {e}") from None
    finally:
        s.close()
    if len(data) < 16:
        raise NatError("short NAT-PMP response")
    ver, op, result, _epoch, _iport, eport, lease = struct.unpack(
        ">BBHIHHI", data[:16])
    if result != 0 or op != 128 + opcode:
        raise NatError(f"NAT-PMP mapping refused (result={result})")
    return eport, lease


def open_external_port(port: int, internal_ip: str, protocol: str = "TCP",
                       gateway_ip: str | None = None,
                       ssdp_target=None) -> str:
    """Best effort: UPnP first, NAT-PMP fallback (upnp.c strategy).
    -> human-readable description of what was opened."""
    try:
        gw = UpnpGateway.discover(target=ssdp_target)
        gw.add_port_mapping(port, port, internal_ip, protocol)
        return f"UPnP mapping {protocol}:{port} -> {internal_ip}:{port}"
    except NatError as first:
        if gateway_ip:
            eport, lease = natpmp_map(gateway_ip, port, port, protocol)
            return f"NAT-PMP mapping {protocol}:{eport} (lease {lease}s)"
        raise NatError(f"no NAT traversal available ({first})") from None
