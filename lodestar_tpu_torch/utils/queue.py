"""Bounded async job queue with concurrency control (the port's copy of
the JAX package's `utils/queue.py`, after the reference's
`beacon-node/src/util/queue/itemQueue.ts` `JobItemQueue`): a FIFO/LIFO
bounded queue that runs an async processor with a concurrency limit, drops
(errors) items beyond ``max_length``, and exposes metrics hooks. The
network's gossip validation queues use it.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Awaitable, Callable, Generic, TypeVar

from .errors import ErrorAborted, LodestarError

T = TypeVar("T")
R = TypeVar("R")


class QueueType(str, Enum):
    FIFO = "FIFO"
    LIFO = "LIFO"


class QueueError(LodestarError):
    pass


@dataclass
class QueueMetrics:
    length: int = 0
    dropped_jobs: int = 0
    job_time_total: float = 0.0
    job_wait_time_total: float = 0.0
    jobs_done: int = 0

    def observe_job(self, wait: float, duration: float) -> None:
        self.jobs_done += 1
        self.job_wait_time_total += wait
        self.job_time_total += duration


@dataclass
class _Item(Generic[T]):
    args: T
    added_at: float
    future: "asyncio.Future[Any]" = field(default=None)  # type: ignore[assignment]


class JobItemQueue(Generic[T, R]):
    """Run ``process(item)`` for pushed items with bounded queue + concurrency.

    Reference semantics (itemQueue.ts:11): if the queue is full the *oldest*
    pending item is dropped for LIFO, the new item is rejected for FIFO.
    """

    def __init__(
        self,
        process: Callable[[T], Awaitable[R]],
        max_length: int = 1024,
        max_concurrency: int = 1,
        queue_type: QueueType = QueueType.FIFO,
        yield_every_ms: float = 50.0,
        name: str = "queue",
    ):
        self._process = process
        self.max_length = max_length
        self.max_concurrency = max_concurrency
        self.queue_type = queue_type
        self.yield_every_ms = yield_every_ms
        self.name = name
        self.metrics = QueueMetrics()
        self._items: deque[_Item[T]] = deque()
        self._running = 0
        self._closed = False

    def __len__(self) -> int:
        return len(self._items)

    async def push(self, args: T) -> R:
        """Enqueue and await the processed result."""
        if self._closed:
            raise ErrorAborted(f"queue {self.name} closed")
        if len(self._items) >= self.max_length:
            self.metrics.dropped_jobs += 1
            if self.queue_type is QueueType.LIFO:
                # Drop the oldest pending job to make room (reference drops
                # from the tail end for LIFO queues).
                dropped = self._items.popleft()
                if not dropped.future.done():
                    dropped.future.set_exception(
                        QueueError({"code": "QUEUE_MAX_LENGTH", "queue": self.name})
                    )
            else:
                raise QueueError({"code": "QUEUE_MAX_LENGTH", "queue": self.name})

        item: _Item[T] = _Item(args=args, added_at=time.monotonic())
        item.future = asyncio.get_running_loop().create_future()
        self._items.append(item)
        self.metrics.length = len(self._items)
        self._maybe_spawn()
        return await item.future

    def _maybe_spawn(self) -> None:
        while self._running < self.max_concurrency and self._items:
            item = self._items.pop() if self.queue_type is QueueType.LIFO else self._items.popleft()
            self._running += 1
            asyncio.get_running_loop().create_task(self._run(item))

    async def _run(self, item: _Item[T]) -> None:
        start = time.monotonic()
        wait = start - item.added_at
        try:
            result = await self._process(item.args)
            if not item.future.done():
                item.future.set_result(result)
        except Exception as e:  # noqa: BLE001 — propagate to caller's future
            if not item.future.done():
                item.future.set_exception(e)
        finally:
            self.metrics.observe_job(wait, time.monotonic() - start)
            self._running -= 1
            self.metrics.length = len(self._items)
            self._maybe_spawn()

    def close(self) -> None:
        self._closed = True
        while self._items:
            item = self._items.popleft()
            if not item.future.done():
                item.future.set_exception(ErrorAborted(f"queue {self.name} closed"))
