"""Fetch SSH public keys for forge users over HTTPS (github:/gitlab: specs).

Counterpart of the reference's lib/crypto/https_keys.c + lib/network/
http_client.c (BearSSL HTTPS GET of https://github.com/<user>.keys /
https://gitlab.com/<user>.keys feeding the SSH auth whitelist). Here the
TLS client is stdlib ssl; the forge base URLs and the trust anchor are
injectable so tests exercise the full HTTPS path against a local
self-signed server with ZERO egress (the same fake-server pattern as the
UPnP router and update-checker tests).

Security notes:
- certificate verification is ALWAYS on (ssl.create_default_context);
  `cafile` only swaps the trust anchor, it never disables checking.
- responses are size-capped and parsed as authorized_keys lines; only
  ssh-ed25519 entries are kept (the only key type the handshake accepts,
  net/sshauth.py).
"""

from __future__ import annotations

import ssl
import urllib.error
import urllib.request

import re

from asciichat_tpu_torch.net.sshauth import (AuthorizedKeys, SshAuthError,
                                       parse_authorized_keys)
from asciichat_tpu_torch.utils.logsys import get_logger

log = get_logger("httpskeys")

FORGE_URLS = {
    "github": "https://github.com/{user}.keys",
    "gitlab": "https://gitlab.com/{user}.keys",
}
MAX_RESPONSE = 256 * 1024  # a keys page is a few hundred bytes; cap hard


class _PinnedHostRedirect(urllib.request.HTTPRedirectHandler):
    """Follow redirects only to https:// targets ON THE ORIGINAL FORGE HOST.

    The reference's https_keys.c does one direct BearSSL GET and follows no
    redirects at all; auth-material provenance matters as much as transport
    encryption, so a compromised/misconfigured forge must not be able to
    302 the fetch to an arbitrary third-party https host (urllib would
    follow up to 10 hops). Same-host redirects (github's trailing-slash
    normalizations) remain usable."""

    def __init__(self, host: str):
        self._host = host.lower()

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        from urllib.parse import urlsplit

        parts = urlsplit(newurl)
        if parts.scheme.lower() != "https":
            raise urllib.error.URLError(
                f"refusing non-HTTPS redirect to {newurl!r}")
        if (parts.hostname or "").lower() != self._host:
            raise urllib.error.URLError(
                f"refusing cross-host redirect to {newurl!r} "
                f"(key fetch is pinned to {self._host})")
        return super().redirect_request(req, fp, code, msg, headers, newurl)


def fetch_keys_text(spec: str, *, forge_urls: dict[str, str] | None = None,
                    cafile: str | None = None, timeout: float = 10.0) -> str:
    """GET the authorized_keys-format text for 'github:user' / 'gitlab:user'."""
    forge, _, user = spec.partition(":")
    forge_urls = forge_urls or FORGE_URLS
    if forge not in forge_urls or not user:
        raise SshAuthError(f"bad key spec {spec!r} (want github:USER or gitlab:USER)")
    # allowlist, not blocklist: a blocklist let control characters (CR in
    # a config file) through to urlopen, which raises InvalidURL — a
    # ValueError escaping the SshAuthError contract below
    if not re.fullmatch(r"[A-Za-z0-9._-]+", user):
        raise SshAuthError(f"bad forge username {user!r}")
    url = forge_urls[forge].format(user=user)
    if not url.lower().startswith("https://"):
        # same rule as the redirect guard below: key material is only ever
        # fetched over verified TLS (https_keys.c is HTTPS-only by linkage)
        raise SshAuthError(f"forge URL must be https:// (got {url!r})")
    ctx = ssl.create_default_context(cafile=cafile)
    # urllib's default redirect handler happily follows an https -> http
    # Location (silent plaintext downgrade of auth material) or a 302 to
    # an arbitrary third-party host; pin redirects to https on the forge's
    # own host instead
    from urllib.parse import urlsplit as _urlsplit

    opener = urllib.request.build_opener(
        _PinnedHostRedirect(_urlsplit(url).hostname or ""),
        urllib.request.HTTPSHandler(context=ctx))
    try:
        with opener.open(url, timeout=timeout) as r:
            if r.status != 200:
                raise SshAuthError(f"{url}: HTTP {r.status}")
            body = r.read(MAX_RESPONSE + 1)
    except (urllib.error.URLError, OSError, ssl.SSLError) as e:
        raise SshAuthError(f"{url}: {e}") from e
    if len(body) > MAX_RESPONSE:
        raise SshAuthError(f"{url}: response exceeds {MAX_RESPONSE} bytes")
    return body.decode("utf-8", errors="replace")


def load_allowed_keys(spec: str, **kw) -> AuthorizedKeys:
    """AuthorizedKeys from a file path OR comma-separated forge specs
    ('github:alice,gitlab:bob'); the file path branch matches
    AuthorizedKeys.load exactly."""
    # Deployment overrides FIRST: self-hosted forges (enterprise GitLab)
    # swap the base URLs; private CAs swap the trust anchor. Also the test
    # seam for the zero-egress fake-forge HTTPS server. These must be
    # resolved BEFORE the file-vs-forge decision, or a custom-named forge
    # ('forge:alice' with ASCIICHAT_FORGE_URLS={'forge': ...}) would fall
    # into the file branch and crash on open().
    import json as _json
    import os as _os

    if "forge_urls" not in kw and _os.environ.get("ASCIICHAT_FORGE_URLS"):
        raw = _os.environ["ASCIICHAT_FORGE_URLS"]
        try:
            parsed = _json.loads(raw)
            if not (isinstance(parsed, dict)
                    and all(isinstance(k, str) and isinstance(v, str)
                            for k, v in parsed.items())):
                raise ValueError("not a {forge: url} object")
        except ValueError as e:
            # keep the SshAuthError contract: a typo'd env var must surface
            # as a clear auth-config error, not a JSONDecodeError traceback
            raise SshAuthError(f"bad ASCIICHAT_FORGE_URLS: {e}") from e
        kw["forge_urls"] = parsed
    if "cafile" not in kw and _os.environ.get("ASCIICHAT_FORGE_CA"):
        kw["cafile"] = _os.environ["ASCIICHAT_FORGE_CA"]
    effective = kw.get("forge_urls") or FORGE_URLS
    if not any(part.partition(":")[0] in effective
               for part in spec.split(",")):
        return AuthorizedKeys.load(spec)
    blobs: list[bytes] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        text = fetch_keys_text(part, **kw)
        got = parse_authorized_keys(text)
        log.info("fetched %d ed25519 key(s) for %s", len(got), part)
        blobs.extend(got)
    if not blobs:
        raise SshAuthError(f"no usable ed25519 keys from {spec!r}")
    return AuthorizedKeys(blobs)
