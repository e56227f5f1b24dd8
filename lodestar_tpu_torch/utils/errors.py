"""Typed errors (the port's copy of the JAX package's `utils/errors.py`,
after the reference's `utils/src/errors.ts`): errors carry a structured
``type`` dict so callers can branch on error codes rather than parse
messages.
"""

from __future__ import annotations

from typing import Any, Mapping


class LodestarError(Exception):
    """Base error carrying a structured metadata object with a ``code`` key."""

    def __init__(self, error_type: Mapping[str, Any], message: str | None = None):
        self.type = dict(error_type)
        self.code: str = str(self.type.get("code", "ERR_UNKNOWN"))
        super().__init__(message or self._format())

    def _format(self) -> str:
        meta = ", ".join(f"{k}={v}" for k, v in self.type.items() if k != "code")
        return f"{self.code}({meta})" if meta else self.code

    def get_metadata(self) -> dict[str, Any]:
        return dict(self.type)


class ErrorAborted(LodestarError):
    """Raised when an operation is interrupted by an abort signal
    (reference: utils/src/errors.ts `ErrorAborted`)."""

    def __init__(self, message: str = "aborted"):
        super().__init__({"code": "ERR_ABORTED"}, message)


class TimeoutError_(LodestarError):
    def __init__(self, message: str = "timeout"):
        super().__init__({"code": "ERR_TIMEOUT"}, message)
