"""Error system: typed error codes + thread-local error context.

Parity with lib/asciichat_errno.c: a stable enum of error codes (used on the
wire in ERROR_MESSAGE packets), exceptions carrying a code, and a
thread-local "last error" context with SET_ERRNO/HAS_ERRNO semantics so
non-raising paths can record diagnostics.
"""

from __future__ import annotations

import enum
import threading


class ErrorCode(enum.IntEnum):
    OK = 0
    INVALID_PARAM = 1
    INVALID_STATE = 2
    MEMORY = 3
    BUFFER = 4
    NETWORK = 5
    NETWORK_SIZE = 6
    CRYPTO = 7
    TERMINAL = 8
    MEDIA = 9
    TIMEOUT = 10
    RATE_LIMITED = 11
    SESSION_NOT_FOUND = 12
    AUTH_FAILED = 13
    PROTOCOL = 14
    UNSUPPORTED = 15


class AsciiChatError(Exception):
    def __init__(self, code: ErrorCode, message: str = ""):
        super().__init__(message or code.name)
        self.code = code


_ctx = threading.local()


def set_errno(code: ErrorCode, message: str = "") -> ErrorCode:
    """Record the error in thread-local context (SET_ERRNO analog)."""
    _ctx.code = code
    _ctx.message = message
    return code


def get_errno() -> tuple[ErrorCode, str]:
    return getattr(_ctx, "code", ErrorCode.OK), getattr(_ctx, "message", "")


def has_errno() -> bool:
    return getattr(_ctx, "code", ErrorCode.OK) != ErrorCode.OK


def clear_errno() -> None:
    _ctx.code = ErrorCode.OK
    _ctx.message = ""


def error_string(code: ErrorCode) -> str:
    return {
        ErrorCode.OK: "success",
        ErrorCode.INVALID_PARAM: "invalid parameter",
        ErrorCode.INVALID_STATE: "invalid state",
        ErrorCode.MEMORY: "out of memory",
        ErrorCode.BUFFER: "buffer too small",
        ErrorCode.NETWORK: "network error",
        ErrorCode.NETWORK_SIZE: "packet too large",
        ErrorCode.CRYPTO: "cryptographic failure",
        ErrorCode.TERMINAL: "terminal error",
        ErrorCode.MEDIA: "media source error",
        ErrorCode.TIMEOUT: "operation timed out",
        ErrorCode.RATE_LIMITED: "rate limited",
        ErrorCode.SESSION_NOT_FOUND: "session not found",
        ErrorCode.AUTH_FAILED: "authentication failed",
        ErrorCode.PROTOCOL: "protocol violation",
        ErrorCode.UNSUPPORTED: "unsupported operation",
    }.get(code, f"unknown error {int(code)}")
