"""sleep / retry / timeout helpers for coroutines: the port's copy of the
JAX package's `utils/promise.py`, after the reference's
`packages/utils/src/{sleep,retry,timeout}.ts`.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, TypeVar

from .errors import ErrorAborted, TimeoutError_

T = TypeVar("T")


async def sleep(seconds: float, abort_event: asyncio.Event | None = None) -> None:
    """Sleep, waking early (with ErrorAborted) if the abort event fires."""
    if abort_event is None:
        await asyncio.sleep(seconds)
        return
    if abort_event.is_set():
        raise ErrorAborted()
    try:
        await asyncio.wait_for(abort_event.wait(), timeout=seconds)
        raise ErrorAborted()
    except asyncio.TimeoutError:
        return


async def with_timeout(aw: Awaitable[T], timeout: float) -> T:
    try:
        return await asyncio.wait_for(aw, timeout=timeout)
    except asyncio.TimeoutError as e:
        raise TimeoutError_() from e


async def retry(
    fn: Callable[[], Awaitable[T]],
    retries: int = 3,
    retry_delay: float = 0.0,
    should_retry: Callable[[Exception], bool] | None = None,
) -> T:
    last_error: Exception | None = None
    for attempt in range(retries):
        try:
            return await fn()
        except Exception as e:  # noqa: BLE001
            last_error = e
            if should_retry is not None and not should_retry(e):
                break
            if attempt < retries - 1 and retry_delay > 0:
                await asyncio.sleep(retry_delay)
    assert last_error is not None
    raise last_error
