"""SDP offer/answer for WebRTC DataChannel signaling (RFC 8866 + 8839/8841).

The reference's browsers negotiate DataChannels with standard SDP through
the signaling server (lib/network/webrtc/sdp.c builds/parses the same
m=application sections via libdatachannel). This module is the text codec
between a browser's RTCPeerConnection SDP and this framework's internal
signaling-blob shape (net/webrtc.IceLiteAgent.local_description):

  browser offer --parse()--> desc dict --IceLiteAgent.set_remote
  IceLiteAgent  --answer_for_agent()--> SDP answer text --> browser

Only the application/webrtc-datachannel section matters (no media m-lines);
unknown attributes are ignored on parse, per SDP convention.

The port's copy of ``asciichat_tpu/net/sdp.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# fixed session-level id; SDP requires o= but nothing consumes it here
_O_LINE = "o=- 4611686018427387904 2 IN IP4 127.0.0.1"


@dataclass
class SdpInfo:
    """The subset of an SDP that a DataChannel association needs."""

    ufrag: str = ""
    pwd: str = ""
    fingerprint: str = ""  # "AB:CD:..." (sha-256)
    setup: str = "actpass"  # actpass | active | passive
    mid: str = "0"
    sctp_port: int = 5000
    max_message_size: int = 262144
    ice_lite: bool = False
    candidates: list[dict] = field(default_factory=list)  # {ip, port, type}
    # every m-section of the offer, in order: {kind, proto, fmts, mid,
    # is_app}. A JSEP answer must mirror the offer's m-line count and order
    # (rejecting the ones it doesn't use), or setRemoteDescription fails.
    msections: list[dict] = field(default_factory=list)

    def to_desc(self) -> dict:
        """The internal signaling-blob shape (webrtc.set_remote input)."""
        return {
            "ufrag": self.ufrag,
            "pwd": self.pwd,
            "dtls_fp": self.fingerprint,
            "candidates": [dict(c) for c in self.candidates],
            "setup": self.setup,
            "sctp_port": self.sctp_port,
        }


def parse(sdp: str) -> SdpInfo:
    """Parse the attributes this stack needs from an offer/answer. Tolerates
    session-level vs media-level placement (browsers put ice/fingerprint at
    either) and ignores everything it doesn't know.

    M-section aware: in a BUNDLE offer carrying media m-lines alongside the
    datachannel one (a browser sharing one RTCPeerConnection for media +
    data), the datachannel attributes (mid, sctp-port, setup) are taken from
    the m=application section, not from whichever section happened to be
    parsed last. Candidates are accepted from any section (under BUNDLE they
    ride the first m-section only, RFC 9143 §7.4)."""
    info = SdpInfo()
    cur: dict | None = None  # None = session level
    app_seen = False
    for raw in sdp.replace("\r\n", "\n").split("\n"):
        line = raw.strip()
        if line.startswith("m="):
            parts = line[2:].split()
            kind = parts[0] if parts else ""
            proto = parts[2] if len(parts) > 2 else ""
            is_app = (kind == "application" and "SCTP" in proto.upper()
                      and not app_seen)
            app_seen = app_seen or is_app
            cur = {"kind": kind, "proto": proto, "fmts": parts[3:],
                   "mid": None, "is_app": is_app}
            info.msections.append(cur)
            continue
        # datachannel-scoped attributes: session level or the application
        # m-section (browsers repeat ice creds/fingerprint per section with
        # identical values under BUNDLE, so this loses nothing)
        in_scope = cur is None or cur["is_app"]
        if line.startswith("a=mid:"):
            if cur is not None:
                cur["mid"] = line.split(":", 1)[1]
                if cur["is_app"]:
                    info.mid = cur["mid"]
            else:
                info.mid = line.split(":", 1)[1]
        elif line == "a=ice-lite":
            info.ice_lite = True
        elif line.startswith("a=candidate:"):
            cand = _parse_candidate(line[len("a=candidate:"):])
            if cand is not None and cand not in info.candidates:
                info.candidates.append(cand)
        elif line.startswith("a=ice-ufrag:"):
            # shared transport attributes: the app section wins; a value from
            # another bundled section fills in only if none was seen (RFC 8843
            # puts them on the bundle-tagged section, which may be m=audio)
            if in_scope or not info.ufrag:
                info.ufrag = line.split(":", 1)[1]
        elif line.startswith("a=ice-pwd:"):
            if in_scope or not info.pwd:
                info.pwd = line.split(":", 1)[1]
        elif line.startswith("a=fingerprint:"):
            algo_fp = line.split(":", 1)[1].split(None, 1)
            if (len(algo_fp) == 2 and algo_fp[0].lower() == "sha-256"
                    and (in_scope or not info.fingerprint)):
                info.fingerprint = algo_fp[1].strip().upper()
        elif not in_scope:
            continue
        elif line.startswith("a=setup:"):
            info.setup = line.split(":", 1)[1]
        elif line.startswith("a=sctp-port:"):
            info.sctp_port = int(line.split(":", 1)[1])
        elif line.startswith("a=max-message-size:"):
            info.max_message_size = int(line.split(":", 1)[1])
    return info


def parse_candidate_line(line: str) -> dict | None:
    """One trickled candidate (RFC 8838): accepts the wire shapes browsers
    emit — a full ``a=candidate:...`` SDP line, the JSEP ``candidate:...``
    RTCIceCandidate.candidate string, or the bare attribute value. Returns
    the internal {ip, port, type} dict or None for end-of-candidates /
    unusable (TCP, IPv6/mDNS) candidates."""
    line = line.strip()
    for prefix in ("a=candidate:", "candidate:"):
        if line.startswith(prefix):
            return _parse_candidate(line[len(prefix):])
    if line and not line.startswith("a=end-of-candidates"):
        return _parse_candidate(line)
    return None


def _parse_candidate(value: str) -> dict | None:
    """candidate-attribute (RFC 8839 §5.1): foundation component transport
    priority address port 'typ' type ..."""
    parts = value.split()
    if len(parts) < 8 or parts[2].lower() != "udp":
        return None  # TCP candidates are not used by this stack
    try:
        ip, port = parts[4], int(parts[5])
    except ValueError:
        return None
    typ = parts[7] if parts[6] == "typ" else "host"
    if not re.fullmatch(r"[0-9.]+", ip):
        return None  # IPv6/mDNS (.local) candidates: not resolvable here
    return {"ip": ip, "port": port, "type": typ}


def _format_candidates(cands: list[dict]) -> list[str]:
    lines = []
    for i, c in enumerate(cands):
        typ = c.get("type", "host")
        # priority: host above srflx, both below whatever the browser has
        prio = 2130706431 - i if typ == "host" else 1694498815 - i
        lines.append(
            f"a=candidate:{i} 1 udp {prio} {c['ip']} {c['port']} typ {typ}"
        )
    return lines


def build(desc: dict, *, setup: str, ice_lite: bool,
          sctp_port: int = 5000, mid: str = "0",
          offer_sections: list[dict] | None = None) -> str:
    """SDP text from an internal signaling blob (agent.local_description()).
    `setup` is the DTLS role offer/answer: 'actpass' in offers, 'passive'
    or 'active' in answers (RFC 8842). `mid` must ECHO the offer's mid in
    an answer (JSEP; browsers reject a mismatched mid).

    `offer_sections` (SdpInfo.msections from the parsed offer): when given,
    the answer mirrors the offer's m-line count and order — the application
    section is answered in full, every other section is REJECTED with port 0
    and its mid echoed (JSEP §5.3.1; a single-m-line answer to a bundled
    media+data offer fails setRemoteDescription with an m-line mismatch)."""
    lines = [
        "v=0",
        _O_LINE,
        "s=-",
        "t=0 0",
    ]
    if ice_lite:
        lines.append("a=ice-lite")
    app_lines = [
        "m=application 9 UDP/DTLS/SCTP webrtc-datachannel",
        "c=IN IP4 0.0.0.0",
        f"a=ice-ufrag:{desc['ufrag']}",
        f"a=ice-pwd:{desc['pwd']}",
        f"a=fingerprint:sha-256 {desc['dtls_fp']}",
        f"a=setup:{setup}",
        f"a=mid:{mid}",
        f"a=sctp-port:{sctp_port}",
        "a=max-message-size:262144",
    ]
    app_lines += _format_candidates(desc.get("candidates", []))
    sections = [s for s in (offer_sections or []) if s.get("mid") is not None
                or s.get("is_app")]
    if not any(s.get("is_app") for s in sections):
        sections = []  # no recognizable datachannel section: single-section
    lines.append(f"a=group:BUNDLE {mid}")  # only accepted mids (RFC 8843 §7.2)
    lines.append("a=msid-semantic: WMS")
    if not sections:
        lines += app_lines
        return "\r\n".join(lines) + "\r\n"
    for s in sections:
        if s.get("is_app"):
            lines += app_lines
            continue
        # rejected m-section: port 0, proto + formats echoed, mid echoed,
        # no transport attributes (RFC 8866 §5.14 / JSEP rejection shape)
        fmts = " ".join(s.get("fmts") or ["0"])
        lines += [
            f"m={s['kind']} 0 {s['proto']} {fmts}",
            "c=IN IP4 0.0.0.0",
            f"a=mid:{s['mid']}",
            "a=inactive",
        ]
    return "\r\n".join(lines) + "\r\n"


def answer_for_agent(agent, offer: "SdpInfo | None" = None, *,
                     public_ip: str | None = None) -> str:
    """SDP answer for a browser's offer, from an ICE-lite controlled agent
    (the server role: a=ice-lite + a=setup:passive, the browser takes the
    active/DTLS-client side; RFC 8839 §4.3, RFC 8842 §5.3). The answer
    echoes the offer's mid — JSEP requires the m-section identification
    to match or setRemoteDescription rejects."""
    desc = agent.local_description()
    if public_ip:
        port = agent.local_port
        cands = [c for c in desc["candidates"] if c["ip"] != "127.0.0.1"]
        if not any(c["ip"] == public_ip for c in cands):
            cands.append({"ip": public_ip, "port": port, "type": "host"})
        desc["candidates"] = cands
    return build(desc, setup="passive", ice_lite=True,
                 mid=offer.mid if offer else "0",
                 offer_sections=offer.msections if offer else None)


def offer_for_agent(agent) -> str:
    """SDP offer from a controlling agent (the browser-role side; used by
    tests and by native clients dialing a WebRTC-only listener)."""
    return build(agent.local_description(), setup="actpass", ice_lite=False)
