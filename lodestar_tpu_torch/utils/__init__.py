"""Shared utilities (the port's copies of the JAX package's `utils/`
modules, after @lodestar/utils)."""

from .bytes import (  # noqa: F401
    bytes32_rjust,
    bytes_to_int,
    from_hex,
    int_to_bytes,
    to_hex,
    uint64_to_bytes,
    xor_bytes,
)
from .errors import ErrorAborted, LodestarError, TimeoutError_  # noqa: F401
from .logger import get_logger  # noqa: F401
from .promise import retry, sleep, with_timeout  # noqa: F401
from .queue import JobItemQueue, QueueError, QueueType  # noqa: F401
