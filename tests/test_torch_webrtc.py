"""The port's WebRTC stack on the CPU: STUN (asciichat_tpu_torch/net/stun.py),
SDP (net/sdp.py), the ICE-lite agent and its secretbox channel
(net/webrtc.py), UPnP (net/upnp.py).

The JAX package's tests of these modules, tests/test_webrtc.py and
tests/test_ice_hardening.py, run here on the port's modules: each file is
compiled with every ``asciichat_tpu.`` import retargeted to
``asciichat_tpu_torch.`` (:func:`port_jax_tests`), so the cases are the
same code and keep their names. Then the two packages' codecs against each
other: the same inputs give the same STUN, SDP and SCTP bytes, and each
side parses what the other wrote; a port agent and a JAX agent connect and
carry ACIP packets both ways. Importing ``net/webrtc`` or
``apps/webclient`` imports neither ``net/crypto`` nor ``cryptography``."""

import ast
import asyncio
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from asciichat_tpu.net import sdp as jsdp
from asciichat_tpu.net import stun as jstun
from asciichat_tpu_torch.net import packet as tpkt
from asciichat_tpu_torch.net import sdp as tsdp
from asciichat_tpu_torch.net import stun as tstun

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
LIMIT = 30.0  # seconds for any one socket test here


def port_jax_tests(namespace: dict, jax_test_file: str, only=None) -> None:
    """Compile the JAX package's ``tests/<jax_test_file>`` with
    ``asciichat_tpu.`` replaced by ``asciichat_tpu_torch.`` into a module of
    its own, and put its tests (all, or the names in ``only``), fixtures and
    ``pytestmark`` into ``namespace``, where pytest collects them under their
    own names, and check that every one of them was. Asserts are rewritten
    as pytest rewrites a test module's, so a failure shows its values."""
    from _pytest.assertion.rewrite import rewrite_asserts

    path = TESTS / jax_test_file
    source = path.read_text().replace("asciichat_tpu.", "asciichat_tpu_torch.")
    tree = ast.parse(source, str(path))
    defs = {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if only is not None:
        missing = set(only) - defs
        assert not missing, f"{jax_test_file} has no {sorted(missing)}"
        tree.body = [node for node in tree.body
                     if not (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and node.name.startswith("test_") and node.name not in only)]
    rewrite_asserts(tree, source.encode(), path)
    module = types.ModuleType(f"port_of_{path.stem}", f"{jax_test_file} on the port")
    module.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), module.__dict__)
    tests = []
    for name, obj in vars(module).items():
        is_fixture = hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ == "FixtureFunctionDefinition"
        if name.startswith("test_") and callable(obj):
            assert name not in namespace, f"{name} is defined twice"
            namespace[name] = obj
            tests.append(name)
        elif is_fixture:
            assert name not in namespace, f"fixture {name} is defined twice"
            namespace[name] = obj
    want = [name for name in defs if name.startswith("test_")
            and (only is None or name in only)]
    assert sorted(tests) == sorted(want), f"{jax_test_file}: {set(want) ^ set(tests)}"
    mark = getattr(module, "pytestmark", None)
    if mark is not None:
        marks = mark if isinstance(mark, list) else [mark]
        for name in tests:
            for m in marks:
                namespace[name] = m(namespace[name])


# tests/test_webrtc.py (STUN, the agent, the secretbox channel, UPnP, relay)
# and tests/test_ice_hardening.py (consent, re-nomination, trickle, relay
# fallback), all of them, on the port's modules
port_jax_tests(globals(), "test_webrtc.py")
port_jax_tests(globals(), "test_ice_hardening.py")


# -- the two packages' codecs give the same bytes --------------------------------

TXID = bytes(range(12))
PWD = b"p" * 22
CHROME_OFFER = (  # a bundled audio + data offer: the answer mirrors its m-lines
    "v=0\r\no=- 163128102 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
    "a=group:BUNDLE 0 1\r\na=msid-semantic: WMS\r\n"
    "m=audio 9 UDP/TLS/RTP/SAVPF 111 63\r\nc=IN IP4 0.0.0.0\r\na=mid:0\r\n"
    "a=ice-ufrag:x9Qb\r\na=ice-pwd:ByT4LqSknZzz0PPalJtOZBuP\r\n"
    "m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\nc=IN IP4 0.0.0.0\r\n"
    "a=ice-ufrag:x9Qb\r\na=ice-pwd:ByT4LqSknZzz0PPalJtOZBuP\r\n"
    "a=fingerprint:sha-256 " + ":".join(["7B"] * 32) + "\r\n"
    "a=setup:actpass\r\na=mid:1\r\na=sctp-port:5000\r\na=max-message-size:65536\r\n"
    "a=candidate:1 1 udp 2122260223 abc-def.local 56143 typ host\r\n"
    "a=candidate:2 1 udp 2122194687 10.0.0.17 49203 typ host\r\n"
    "a=candidate:3 1 udp 1686052607 203.0.113.44 49203 typ srflx raddr 10.0.0.17\r\n"
)


@pytest.mark.parametrize("message", ["request_controlling", "request_controlled",
                                     "response", "bare", "error_attrs"])
def test_stun_bytes_equal_across_packages(message):
    build = {
        # the default tie-breaker is drawn per process: give one
        "request_controlling": lambda s: s.make_binding_request(
            TXID, "ab:cd", PWD, True, tiebreaker=b"\x02" * 8),
        "request_controlled": lambda s: s.make_binding_request(
            TXID, "ab:cd", PWD, False, tiebreaker=b"\x01" * 8),
        "response": lambda s: s.make_binding_response(TXID, ("192.168.1.7", 54321), PWD),
        "bare": lambda s: s.build(s.BINDING_REQUEST, TXID, []),
        "error_attrs": lambda s: s.build(0x0111, TXID, [(0x0009, b"\x00\x00\x04\x01odd"),
                                                         (0x8022, b"x" * 5)]),
    }[message]
    ours, theirs = build(tstun), build(jstun)
    assert ours == theirs
    assert tstun.parse(theirs) == jstun.parse(ours)
    if message != "bare" and message != "error_attrs":
        assert tstun.verify_integrity(theirs, PWD) and jstun.verify_integrity(ours, PWD)
    assert tstun.xor_mapped_address(("10.1.2.3", 9)) == jstun.xor_mapped_address(("10.1.2.3", 9))


@pytest.mark.parametrize("setup,ice_lite,sections", [
    ("actpass", False, False), ("passive", True, False), ("passive", True, True)],
    ids=["offer", "answer", "answer_mirroring_offer"])
def test_sdp_text_equal_across_packages(setup, ice_lite, sections):
    desc = {"ufrag": "Xy3k", "pwd": "p" * 22, "dtls_fp": ":".join(["AB"] * 32),
            "candidates": [{"ip": "192.168.1.5", "port": 41234},
                           {"ip": "203.0.113.9", "port": 52000, "type": "srflx"}]}
    kw = {}
    if sections:
        kw = {"mid": "1", "offer_sections": jsdp.parse(CHROME_OFFER).msections}
    ours = tsdp.build(desc, setup=setup, ice_lite=ice_lite, **kw)
    assert ours == jsdp.build(desc, setup=setup, ice_lite=ice_lite, **kw)
    assert tsdp.parse(ours) == tsdp.SdpInfo(**vars(jsdp.parse(ours)))


def test_sdp_parse_equal_across_packages():
    ours, theirs = tsdp.parse(CHROME_OFFER), jsdp.parse(CHROME_OFFER)
    assert vars(ours) == vars(theirs)
    assert ours.to_desc() == theirs.to_desc()
    assert ours.mid == "1" and [c["ip"] for c in ours.candidates] == ["10.0.0.17",
                                                                      "203.0.113.44"]
    for line in ("a=candidate:2 1 udp 2122194687 10.0.0.17 49203 typ host",
                 "candidate:9 1 tcp 1 10.0.0.1 9 typ host", "a=end-of-candidates"):
        assert tsdp.parse_candidate_line(line) == jsdp.parse_candidate_line(line)


# -- a port agent and a JAX agent connect ------------------------------------------

@pytest.mark.parametrize("dtls", [False, True], ids=["secretbox", "datachannel"])
@pytest.mark.parametrize("controlling", ["port", "jax"])
def test_agents_connect_across_packages(controlling, dtls):
    """ICE between the two packages' agents on loopback, then ACIP packets
    both ways over the negotiated channel: the secretbox stream, or DTLS +
    SCTP DataChannels."""
    from asciichat_tpu.net import packet as jpkt
    from asciichat_tpu.net.webrtc import IceLiteAgent as JaxAgent
    from asciichat_tpu_torch.net.webrtc import IceLiteAgent as PortAgent

    if dtls:
        from asciichat_tpu_torch.net import dtls as dtls_mod

        if not dtls_mod.available():
            pytest.skip("OpenSSL 3 shared libraries not present")

    async def run():
        first, second = (PortAgent, JaxAgent) if controlling == "port" else (JaxAgent, PortAgent)
        a, b = first(controlling=True, dtls=dtls), second(controlling=False, dtls=dtls)
        await a.start("127.0.0.1")
        await b.start("127.0.0.1")
        try:
            b.set_remote(a.local_description())
            a.set_remote(b.local_description())
            ch_a = await (await a.wait_connected(10)).wait_ready(10)
            ch_b = await (await b.wait_connected(10)).wait_ready(10)
            assert type(ch_a).__name__ == type(ch_b).__name__ == (
                "DataChannelTransport" if dtls else "SecureP2PChannel")
            await ch_a.send(tpkt.PacketType.PING, b"across")
            assert await asyncio.wait_for(ch_b.recv(), 10) == (jpkt.PacketType.PING, b"across")
            big = os.urandom(70_000)
            await ch_b.send(jpkt.PacketType.ASCII_FRAME, big)
            assert await asyncio.wait_for(ch_a.recv(), 10) == (tpkt.PacketType.ASCII_FRAME, big)
        finally:
            a.close()
            b.close()

    asyncio.run(asyncio.wait_for(run(), LIMIT))


# -- importing the signaling path needs no cryptography ----------------------------

def test_webrtc_and_webclient_import_without_cryptography():
    """``net/webrtc`` and ``apps/webclient`` import with ``cryptography``
    blocked and load neither it nor ``net/crypto``; an agent then says what
    it needs."""
    code = (
        "import sys\n"
        "for name in ('asciichat_tpu', 'jax', 'cryptography'):\n"
        "    sys.modules[name] = None\n"
        "from asciichat_tpu_torch.net import webrtc\n"
        "from asciichat_tpu_torch.apps import webclient\n"
        "from asciichat_tpu_torch.net import datachannel, sdp, stun, dtls\n"
        "assert 'asciichat_tpu_torch.net.crypto' not in sys.modules\n"
        "assert webclient.WebRtcGateway(None).available() is False\n"
        "try:\n"
        "    webrtc.IceLiteAgent(controlling=True)\n"
        "except ImportError as e:\n"
        "    print('agent:', e)\n")
    env = dict(os.environ, ASCIICHAT_TORCH_DEVICE="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("agent: ") and "cryptography" in out.stdout
