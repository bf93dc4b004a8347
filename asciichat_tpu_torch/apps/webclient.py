"""Browser client HTTP routing: serves the web app next to the WebSocket.

The port's copy of ``asciichat_tpu/apps/webclient.py``. Importing it
imports neither ``net/crypto`` nor ``cryptography``: ``WebRtcGateway`` reaches
them only when it answers an offer.

Parity with the reference's web stack (web/ TypeScript app + src/web/
main_wasm.c WASM render core served to browsers over the WebSocket
transport): the server's WebSocket listener answers plain HTTP GETs with
the static app from asciichat_tpu_torch/web/ (parse-once cell-grid renderer
on canvas), plus dynamic endpoints:

- POST /webrtc/offer — WebRTC DataChannel signaling (lib/network/webrtc/
  + src/discovery-service/signaling.c role for direct-to-server browsers):
  body is the browser's SDP offer, response is the server's SDP answer;
  the resulting ICE+DTLS+SCTP DataChannel then joins the server exactly
  like a TCP or WebSocket client (same ACIP handler).
- /servers.json — LAN server browse via one mDNS sweep (client --browse in
  the browser; lib/network/mdns/ role), cached a few seconds.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

from asciichat_tpu_torch import web
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("webclient")


class _BrowseCache:
    """mDNS sweeps are 2 s blocking scans: serve a cached roster and refresh
    it in a background thread at most every `ttl` seconds."""

    def __init__(self, ttl: float = 5.0):
        self.ttl = ttl
        self._result: list[dict] = []
        self._stamp = 0.0
        self._busy = False
        self._lock = threading.Lock()

    def get(self) -> list[dict]:
        with self._lock:
            stale = time.monotonic() - self._stamp > self.ttl
            if stale and not self._busy:
                self._busy = True
                threading.Thread(target=self._refresh, daemon=True).start()
            return list(self._result)

    def _refresh(self) -> None:
        result = None
        try:
            from asciichat_tpu_torch.net.mdns import discover

            found = discover(timeout=2.0)
            result = [
                {"name": s.instance, "host": s.address, "port": s.port,
                 "ws": s.txt.get("ws", "0")}
                for s in found
            ]
        except Exception:
            pass  # transient sweep failure: keep the last-good roster
        with self._lock:
            if result is not None:
                self._result = result
            self._stamp = time.monotonic()
            self._busy = False


def make_http_handler():
    """A `pages` callable for net.websocket.serve_ws: the static assets and
    /servers.json."""
    cache = _BrowseCache()

    def handler(path: str) -> tuple[str, bytes] | None:
        route = path.split("?", 1)[0]
        if route == "/servers.json":
            return ("application/json", json.dumps(cache.get()).encode())
        return web.get_asset(route)

    return handler


class WebRtcGateway:
    """Answers browser RTCPeerConnection offers and hands established
    DataChannels to the server's connection handler.

    The browser is the full-ICE controlling agent and DTLS client; the
    server side is ICE-lite + a=setup:passive (RFC 8839 §4.3/RFC 8842
    §5.3, the standard server posture). One POST = one dedicated UDP
    socket/agent; the channel then speaks plain ACIP, so the server treats
    a browser on WebRTC identically to one on TCP or WebSocket."""

    def __init__(self, handler, max_pending: int = 64):
        self._handler = handler  # async def handler(transport)
        self._max_pending = max_pending
        self._tasks: set[asyncio.Task] = set()
        self._agents_by_ufrag: dict[str, object] = {}  # trickle routing
        self._task_by_agent: dict[object, asyncio.Task] = {}
        self.closed = False

    def available(self) -> bool:
        """Signaling needs DTLS (the system libssl) and an agent's X25519
        key (net/crypto, the `cryptography` package): without either the
        server serves no POST route, as the JAX server does without DTLS."""
        from asciichat_tpu_torch.net import dtls

        if not dtls.available():
            return False
        try:
            import cryptography  # noqa: F401
        except ImportError:
            return False
        return True

    async def on_offer(self, body: bytes) -> tuple[str, bytes] | None:
        """POST /webrtc/offer handler: SDP offer in, SDP answer out.
        Returns None (-> 404) for malformed or unsupportable offers."""
        from asciichat_tpu_torch.net import sdp
        from asciichat_tpu_torch.net.webrtc import IceLiteAgent

        if self.closed:
            return None
        try:
            # sdp.parse raises ValueError on malformed numeric attributes
            # (a=sctp-port:junk) — the documented contract is 404, not a
            # dead TCP connection with no HTTP response
            info = sdp.parse(body.decode("utf-8", errors="strict"))
        except (UnicodeDecodeError, ValueError):
            return None
        if not (info.ufrag and info.pwd and info.fingerprint):
            return None  # not a DataChannel offer this stack can secure
        # a same-ufrag retry REPLACES its in-flight agent rather than adding
        # one, so it is exempt from the max_pending gate — otherwise a
        # legitimate browser retry at max_pending was 404'd while the stale
        # agent kept holding its slot + UDP socket until the 30 s
        # wait_connected timeout (the exact condition the supersede targets)
        if (info.ufrag not in self._agents_by_ufrag
                and len(self._tasks) >= self._max_pending):
            return None
        agent = IceLiteAgent(controlling=False)
        if agent.dtls_identity is None:
            agent.close()
            return None  # no OpenSSL on this host
        try:
            await agent.start()
        except OSError:  # fd exhaustion etc.: answer 404, don't leak the conn
            agent.close()
            return None
        agent.set_remote(info.to_desc())
        answer = sdp.answer_for_agent(agent, info)
        # trickle ICE (RFC 8838): offers may arrive with ZERO candidates —
        # the browser trickles them via POST /webrtc/candidate, keyed by its
        # own ufrag (on_candidate). ICE-lite needs no checks of its own, so
        # the offer is answerable immediately either way.
        # a retried offer with the SAME ufrag supersedes the in-flight agent:
        # cancel the old task NOW (its finally closes the agent/UDP socket)
        # instead of letting it hold a socket + pending slot for up to 60 s
        old = self._agents_by_ufrag.get(info.ufrag)
        if old is not None:
            stale_task = self._task_by_agent.pop(old, None)
            if stale_task is not None:
                stale_task.cancel()
        self._agents_by_ufrag[info.ufrag] = agent
        task = asyncio.get_running_loop().create_task(self._run(agent))
        self._tasks.add(task)
        self._task_by_agent[agent] = task
        task.add_done_callback(self._tasks.discard)
        task.add_done_callback(
            lambda _t, a=agent: self._task_by_agent.pop(a, None))
        def _unroute(_t, u=info.ufrag, a=agent):
            # identity-checked: a retried offer with the SAME ufrag replaces
            # the agent; the stale task's completion must not delete the
            # live replacement's trickle route
            if self._agents_by_ufrag.get(u) is a:
                del self._agents_by_ufrag[u]

        task.add_done_callback(_unroute)
        log.info("webrtc offer accepted (ufrag %s); agent on udp:%d",
                 info.ufrag, agent.local_port)
        return ("application/sdp", answer.encode())

    def on_candidate(self, path: str, body: bytes) -> tuple[str, bytes] | None:
        """POST /webrtc/candidate?ufrag=<offer ufrag> — one trickled
        candidate line per request (RFC 8838). The agent's live check list
        picks it up; unknown ufrag or unusable candidate -> None (404)."""
        from urllib.parse import parse_qs, urlsplit

        from asciichat_tpu_torch.net import sdp

        ufrag = parse_qs(urlsplit(path).query).get("ufrag", [""])[0]
        agent = self._agents_by_ufrag.get(ufrag)
        if agent is None:
            return None
        cand = sdp.parse_candidate_line(body.decode("utf-8", errors="replace"))
        if cand is not None:
            agent.add_remote_candidate(cand)
        # end-of-candidates / unusable lines are acknowledged, not errors
        return ("text/plain", b"ok")

    async def _run(self, agent) -> None:
        try:
            ch = await agent.wait_connected(30)
            await ch.wait_ready(30)
            log.info("webrtc datachannel up from %s", ch.peername)
            await self._handler(ch)
        except (TimeoutError, asyncio.TimeoutError):
            log.info("webrtc offer never completed (browser went away?)")
        except ConnectionError as e:
            log.info("webrtc channel ended: %s", e)
        finally:
            agent.close()

    def close(self) -> None:
        self.closed = True
        for t in list(self._tasks):
            t.cancel()
