"""SSH key authentication: agent protocol client + Ed25519 identity auth.

Counterpart of lib/crypto/ssh/{ssh_agent.c,ssh_keys.c}: clients prove
possession of an SSH identity key — via the ssh-agent protocol over
SSH_AUTH_SOCK (SSH2_AGENTC_REQUEST_IDENTITIES/SIGN_REQUEST, ssh_agent.c:62,
279) or an OpenSSH key file — and the server verifies the signature against
an authorized_keys whitelist (handshake/server.c:331 client_whitelist).

The signature binds the DH session: sig = Ed25519(key, challenge ||
shared_key), the same binding the HMAC password auth uses (crypto.c:927-963),
so a replayed signature from another session is useless.

Wire blob formats are standard SSH (RFC 8709 ssh-ed25519):
  pubkey blob = string("ssh-ed25519") || string(key32)
  sig blob    = string("ssh-ed25519") || string(sig64)
"""

from __future__ import annotations

import os
import socket
import struct

from cryptography.exceptions import InvalidSignature, UnsupportedAlgorithm
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

# agent protocol message types (draft-miller-ssh-agent)
SSH_AGENT_FAILURE = 5
SSH_AGENT_SUCCESS = 6
SSH2_AGENTC_REQUEST_IDENTITIES = 11
SSH2_AGENT_IDENTITIES_ANSWER = 12
SSH2_AGENTC_SIGN_REQUEST = 13
SSH2_AGENT_SIGN_RESPONSE = 14
SSH2_AGENTC_ADD_IDENTITY = 17

KEY_TYPE = b"ssh-ed25519"


class SshAuthError(ValueError):
    pass


def _s(data: bytes) -> bytes:
    """SSH 'string': u32 length prefix."""
    return struct.pack(">I", len(data)) + data


def _read_s(buf: bytes, at: int) -> tuple[bytes, int]:
    if at + 4 > len(buf):
        raise SshAuthError("truncated SSH string")
    (n,) = struct.unpack(">I", buf[at : at + 4])
    if at + 4 + n > len(buf):
        raise SshAuthError("truncated SSH string body")
    return buf[at + 4 : at + 4 + n], at + 4 + n


def pubkey_blob(public_key: Ed25519PublicKey) -> bytes:
    return _s(KEY_TYPE) + _s(public_key.public_bytes_raw())


def parse_pubkey_blob(blob: bytes) -> Ed25519PublicKey:
    ktype, at = _read_s(blob, 0)
    if ktype != KEY_TYPE:
        raise SshAuthError(f"unsupported key type {ktype!r} (ed25519 only)")
    raw, _ = _read_s(blob, at)
    if len(raw) != 32:
        raise SshAuthError("bad ed25519 key length")
    return Ed25519PublicKey.from_public_bytes(raw)


def sig_blob(signature: bytes) -> bytes:
    return _s(KEY_TYPE) + _s(signature)


def parse_sig_blob(blob: bytes) -> bytes:
    stype, at = _read_s(blob, 0)
    if stype != KEY_TYPE:
        raise SshAuthError(f"unsupported signature type {stype!r}")
    sig, _ = _read_s(blob, at)
    return sig


# ---------------------------------------------------------------------------
# ssh-agent client (ssh_agent.c analog)


class SshAgent:
    """Blocking ssh-agent protocol client over SSH_AUTH_SOCK."""

    def __init__(self, sock_path: str | None = None):
        path = sock_path or os.environ.get("SSH_AUTH_SOCK")
        if not path:
            raise SshAuthError("no SSH_AUTH_SOCK (agent not running)")
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(5.0)
        try:
            self._sock.connect(path)
        except OSError as e:
            raise SshAuthError(f"cannot connect to ssh-agent: {e}") from None

    def _rpc(self, msg: bytes) -> bytes:
        try:
            self._sock.sendall(struct.pack(">I", len(msg)) + msg)
            hdr = self._recv_exact(4)
            (n,) = struct.unpack(">I", hdr)
            if n > 1 << 20:
                raise SshAuthError("oversized agent response")
            return self._recv_exact(n)
        except OSError as e:
            # a hung agent (socket.timeout) or dead socket must surface as
            # the auth-failure contract, not an unhandled exception in the
            # handshake executor
            raise SshAuthError(f"ssh-agent I/O failed: {e}") from None

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise SshAuthError("agent connection closed")
            buf += chunk
        return buf

    def list_identities(self) -> list[tuple[bytes, str]]:
        """-> [(pubkey_blob, comment)] (SSH2_AGENTC_REQUEST_IDENTITIES)."""
        resp = self._rpc(bytes([SSH2_AGENTC_REQUEST_IDENTITIES]))
        if not resp or resp[0] != SSH2_AGENT_IDENTITIES_ANSWER:
            raise SshAuthError("agent refused identity listing")
        if len(resp) < 5:
            # a malformed answer must not escape as raw struct.error
            raise SshAuthError("truncated agent identities answer")
        (count,) = struct.unpack(">I", resp[1:5])
        at = 5
        out = []
        for _ in range(count):
            blob, at = _read_s(resp, at)
            comment, at = _read_s(resp, at)
            out.append((blob, comment.decode(errors="replace")))
        return out

    def sign(self, key_blob: bytes, data: bytes) -> bytes:
        """-> raw 64-byte signature (SSH2_AGENTC_SIGN_REQUEST, flags=0)."""
        msg = (bytes([SSH2_AGENTC_SIGN_REQUEST]) + _s(key_blob) + _s(data)
               + struct.pack(">I", 0))
        resp = self._rpc(msg)
        if not resp or resp[0] != SSH2_AGENT_SIGN_RESPONSE:
            raise SshAuthError("agent refused to sign (SSH_AGENT_FAILURE)")
        blob, _ = _read_s(resp, 1)
        return parse_sig_blob(blob)

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# Identity: a signer from an agent key or an OpenSSH key file


class SshIdentity:
    """One usable SSH identity: sign(data) + its pubkey blob. `agent` is
    set for agent-backed identities so the caller can close() the agent
    socket when done (it is otherwise held for the identity's lifetime)."""

    def __init__(self, key_blob: bytes, signer, agent: "SshAgent | None" = None):
        self.key_blob = key_blob
        self._signer = signer
        self.agent = agent

    def sign(self, data: bytes) -> bytes:
        return self._signer(data)

    def close(self) -> None:
        if self.agent is not None:
            self.agent.close()
            self.agent = None

    @staticmethod
    def from_private_key_file(path: str, password: bytes | None = None) -> "SshIdentity":
        """OpenSSH private key file (ssh_keys.c key-file path)."""
        from cryptography.hazmat.primitives.serialization import load_ssh_private_key

        try:
            with open(path, "rb") as f:
                key = load_ssh_private_key(f.read(), password)
        except TypeError:
            # cryptography's signal for an encrypted key with no password
            raise SshAuthError(
                f"SSH key {path!r} is passphrase-protected — load it into "
                "ssh-agent or provide the passphrase") from None
        except (ValueError, OSError, UnsupportedAlgorithm) as e:
            # wrong passphrase / unreadable / not an OpenSSH key: surface
            # the auth-failure contract, not a raw traceback at the CLI
            raise SshAuthError(f"cannot load SSH key {path!r}: {e}") from None
        if not isinstance(key, Ed25519PrivateKey):
            raise SshAuthError("only ed25519 SSH keys are supported")
        return SshIdentity(pubkey_blob(key.public_key()), key.sign)

    @staticmethod
    def from_agent(agent: SshAgent | None = None) -> "SshIdentity":
        """First ed25519 identity held by the agent. When this function
        creates the agent connection itself, it owns it until success —
        error paths close it (a leaked AF_UNIX socket per reconnect
        otherwise) — and hands it to the identity on success."""
        ag = agent or SshAgent()
        try:
            for blob, _comment in ag.list_identities():
                try:
                    parse_pubkey_blob(blob)
                except SshAuthError:
                    continue
                return SshIdentity(blob, lambda data, b=blob: ag.sign(b, data),
                                   agent=ag)
        except SshAuthError:
            if agent is None:
                ag.close()
            raise
        if agent is None:
            ag.close()
        raise SshAuthError("agent holds no ed25519 identities")


# ---------------------------------------------------------------------------
# authorized_keys whitelist (handshake/server.c:331 client_whitelist)


def parse_authorized_keys(text: str) -> list[bytes]:
    """authorized_keys lines ('[options] <type> <base64> [comment]') ->
    raw ed25519 key blobs. Comments, blanks, and non-KEY_TYPE lines are
    skipped (with a log line — silently dropping a real key strands its
    client with no server-side hint). The ONE parser for both file-loaded
    (AuthorizedKeys.load) and forge-fetched (net/httpskeys.py) whitelists
    — they must never accept different sets."""
    import base64
    import re

    from asciichat_tpu_torch.utils.logsys import get_logger

    blobs = []
    skipped = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # real OpenSSH files carry an optional options prefix (restrict,
        # from="...", command="..."); strip quoted sections first so a
        # quoted command can't smuggle a fake keytype token, then find
        # the keytype + base64 pair wherever it sits on the line
        unquoted = re.sub(r'"[^"]*"', "", line)
        m = re.search(r"(?:^|[ \t])" + re.escape(KEY_TYPE.decode())
                      + r"[ \t]+([A-Za-z0-9+/=]+)", " " + unquoted)
        if not m:
            skipped += 1
            continue
        try:
            blobs.append(base64.b64decode(m.group(1)))
        except Exception:
            skipped += 1
            continue
    if skipped:
        get_logger("sshauth").warning(
            "authorized_keys: skipped %d non-ed25519/unparsable line(s)",
            skipped)
    return blobs


class AuthorizedKeys:
    def __init__(self, blobs: list[bytes]):
        self._blobs = set(blobs)

    @staticmethod
    def load(path: str) -> "AuthorizedKeys":
        """authorized_keys format: '<type> <base64> [comment]' per line."""
        blobs = parse_authorized_keys(open(path, encoding="utf-8").read())
        if not blobs:
            raise SshAuthError(f"no usable ed25519 keys in {path}")
        return AuthorizedKeys(blobs)

    def __contains__(self, blob: bytes) -> bool:
        return blob in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)


# ---------------------------------------------------------------------------
# handshake payloads: CRYPTO_AUTH_RESPONSE (key-auth form)


def make_auth_response(identity: SshIdentity, challenge: bytes,
                       shared_key: bytes) -> bytes:
    """string(pubkey_blob) || string(sig over challenge||shared_key) — the
    DH binding mirrors the password HMAC's (crypto.c:927-963)."""
    sig = identity.sign(challenge + shared_key)
    return _s(identity.key_blob) + _s(sig)


def verify_auth_response(payload: bytes, challenge: bytes, shared_key: bytes,
                         allowed: AuthorizedKeys) -> bool:
    """Whitelist + signature check (handshake/server.c:331,491)."""
    try:
        blob, at = _read_s(payload, 0)
        sig, _ = _read_s(payload, at)
        if blob not in allowed:
            return False
        parse_pubkey_blob(blob).verify(sig, challenge + shared_key)
        return True
    except (SshAuthError, InvalidSignature, ValueError):
        return False
