"""GPG identity authentication (lib/crypto/gpg analog).

The second half of the reference's SSH/GPG auth: the client proves
possession of an OpenPGP key by detach-signing the DH-bound challenge
(challenge || shared_key, same binding as net/sshauth.py and the password
HMAC), and the server verifies the signature against a keyring of allowed
public keys. Signing and verification shell out to the gpg CLI (the
reference drives gpg/gpg-agent the same way — smartcard/agent-held keys
work for free).

Wire payload (CRYPTO_AUTH_RESPONSE, AUTH_ALGO_GPG):
    u16 fpr_len || fingerprint-hex || u16 sig_len || detached signature
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile


class GpgAuthError(ValueError):
    pass


def _gpg(args: list[str], gnupghome: str | None = None,
         input_bytes: bytes | None = None) -> subprocess.CompletedProcess:
    if shutil.which("gpg") is None:
        raise GpgAuthError("gpg not found on PATH")
    env = dict(os.environ)
    if gnupghome:
        env["GNUPGHOME"] = gnupghome
    try:
        return subprocess.run(["gpg", "--batch", "--yes", *args],
                              input=input_bytes, capture_output=True, env=env,
                              timeout=30)
    except subprocess.TimeoutExpired:
        # a wedged gpg-agent must surface as an auth failure, not an
        # unhandled exception killing the connection task
        raise GpgAuthError("gpg timed out (wedged agent?)") from None


class GpgIdentity:
    """A signing identity held in a GnuPG keyring (possibly on an agent or
    smartcard — gpg handles that transparently)."""

    def __init__(self, key: str | None = None, gnupghome: str | None = None):
        self.gnupghome = gnupghome
        self.fingerprint = self._resolve_fingerprint(key)

    def _resolve_fingerprint(self, key: str | None) -> str:
        args = ["--list-secret-keys", "--with-colons"]
        if key:
            args.append(key)
        out = _gpg(args, self.gnupghome)
        for line in out.stdout.decode(errors="replace").splitlines():
            if line.startswith("fpr:"):
                return line.split(":")[9]
        raise GpgAuthError(f"no secret GPG key found ({key or 'default'})")

    def sign(self, data: bytes) -> bytes:
        """Detached binary signature over `data` (gpg --detach-sign).
        Plain invocation first so gpg-agent/smartcard pinentry works;
        loopback-with-empty-passphrase only as the headless fallback."""
        base = ["--local-user", self.fingerprint, "--detach-sign",
                "--output", "-"]
        out = _gpg(base, self.gnupghome, input_bytes=data)
        if out.returncode != 0 or not out.stdout:
            out = _gpg(["--pinentry-mode", "loopback", "--passphrase", "",
                        *base], self.gnupghome, input_bytes=data)
        if out.returncode != 0 or not out.stdout:
            raise GpgAuthError(f"gpg signing failed: {out.stderr.decode()[-300:]}")
        return out.stdout


class GpgKeyring:
    """Server-side allowed-keys keyring: verification succeeds only for a
    GOODSIG by a key present in this GNUPGHOME (client_whitelist role)."""

    def __init__(self, gnupghome: str):
        self.gnupghome = gnupghome

    def verify(self, data: bytes, signature: bytes,
               claimed_fpr: str) -> bool:
        with tempfile.TemporaryDirectory() as td:
            sig_path = os.path.join(td, "sig")
            with open(sig_path, "wb") as f:
                f.write(signature)
            # the signed data (challenge || DH SESSION KEY) rides stdin:
            # writing it to a temp file put live session-key material on
            # disk, forensically recoverable from the journal long after
            # the unlink
            out = _gpg(["--status-fd", "1", "--verify", sig_path, "-"],
                       self.gnupghome, input_bytes=data)
        lines = out.stdout.decode(errors="replace").splitlines()
        goodsigs = [ln for ln in lines if ln.startswith("[GNUPG:] GOODSIG")]
        validsigs = [ln for ln in lines if ln.startswith("[GNUPG:] VALIDSIG")]
        bad = [ln for ln in lines
               if ln.startswith(("[GNUPG:] BADSIG", "[GNUPG:] ERRSIG"))]
        # exactly ONE signature, and it must be good: a multi-signature
        # file could couple key A's GOODSIG with key B's VALIDSIG
        # fingerprint (and older gpg could be steered into verifying an
        # embedded inline-signed message instead of the detached data)
        if len(goodsigs) != 1 or len(validsigs) != 1 or bad:
            return False
        # bind the claimed fingerprint: VALIDSIG carries the full fpr
        parts = validsigs[0].split()
        return claimed_fpr.upper() in (parts[2].upper(), parts[-1].upper())


def make_auth_response(identity: GpgIdentity, challenge: bytes,
                       shared_key: bytes) -> bytes:
    fpr = identity.fingerprint.encode()
    sig = identity.sign(challenge + shared_key)
    return struct.pack(">H", len(fpr)) + fpr + struct.pack(">H", len(sig)) + sig


def verify_auth_response(payload: bytes, challenge: bytes, shared_key: bytes,
                         keyring: GpgKeyring) -> bool:
    try:
        (fpr_len,) = struct.unpack(">H", payload[:2])
        fpr = payload[2 : 2 + fpr_len].decode()
        at = 2 + fpr_len
        (sig_len,) = struct.unpack(">H", payload[at : at + 2])
        sig = payload[at + 2 : at + 2 + sig_len]
        if len(sig) != sig_len:
            return False
        return keyring.verify(challenge + shared_key, sig, fpr)
    except (struct.error, UnicodeDecodeError, GpgAuthError):
        return False
