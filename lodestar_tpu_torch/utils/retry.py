"""Jittered exponential backoff behind one policy object (a copy of the JAX
package's `utils/retry.py`).

`RetryPolicy` + `retry_call` is the one retry loop of the serving stack:
`chain/supervisor.py` retries a raised device error through it. The
jitter is symmetric (delay × (1 ± jitter)) so several nodes restarting
against the same dead endpoint do not retry in step.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable


def _always(exc: BaseException) -> bool:
    return True


@dataclass
class RetryPolicy:
    """max_attempts TOTAL tries (1 = no retry); delays grow
    base_delay_s * 2^k, capped at max_delay_s, jittered ± `jitter`
    fraction. `retryable(exc)` gates which failures are worth retrying."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    jitter: float = 0.25
    retryable: Callable[[BaseException], bool] = _always
    sleep: Callable[[float], None] = time.sleep
    rand: Callable[[], float] = field(default=random.random)

    def delay_s(self, failure_index: int) -> float:
        """Jittered backoff delay after the (failure_index+1)-th failure."""
        base = min(self.max_delay_s, self.base_delay_s * (2.0 ** failure_index))
        if self.jitter <= 0:
            return base
        return max(0.0, base * (1.0 + self.jitter * (2.0 * self.rand() - 1.0)))


def retry_call(fn, *, policy: RetryPolicy | None = None, on_error=None):
    """Call `fn()` under `policy`; re-raises the last exception once
    attempts are exhausted or the failure is not retryable.

    `on_error(exc, attempt, will_retry)` fires on every failed attempt
    (attempt is 0-based)."""
    policy = policy or RetryPolicy()
    attempts = max(1, int(policy.max_attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:
            will_retry = attempt + 1 < attempts and policy.retryable(e)
            if on_error is not None:
                on_error(e, attempt, will_retry)
            if not will_retry:
                raise
            policy.sleep(policy.delay_s(attempt))
    raise AssertionError("unreachable")  # pragma: no cover
