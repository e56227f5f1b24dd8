"""The port's `utils/bytes.py`, `utils/promise.py` and `utils/logger.py`
against the JAX package's modules of the same names.

The byte helpers are held equal to the JAX functions on seeded inputs;
the coroutine helpers (sleep with an abort event, with_timeout, retry)
give the same results and raise the same error codes; the logger's trace
filter mirrors `tests/test_spans.py:159` (`test_logger_injects_trace_id`)
over the port's tracer, and `get_logger` names its loggers under the
port's package without configuring a handler. Tolerance: equality.
"""

import asyncio
import logging

import numpy as np
import pytest

from lodestar_tpu.utils import bytes as jbytes
from lodestar_tpu.utils import promise as jpromise
from lodestar_tpu_torch import utils
from lodestar_tpu_torch.observability import spans
from lodestar_tpu_torch.utils import bytes as pbytes
from lodestar_tpu_torch.utils import promise as ppromise
from lodestar_tpu_torch.utils.logger import TraceContextFilter, get_logger


def test_bytes_helpers_equal_jax():
    rng = np.random.default_rng(20261018)
    for _ in range(200):
        n = int(rng.integers(0, 33))
        data = rng.bytes(n)
        other = rng.bytes(n)
        value = int(rng.integers(0, 2**63))
        length = int(rng.integers(8, 33))
        order = ("little", "big")[int(rng.integers(0, 2))]
        assert pbytes.to_hex(data) == jbytes.to_hex(data)
        assert pbytes.from_hex(pbytes.to_hex(data)) == jbytes.from_hex(data.hex()) == data
        assert pbytes.int_to_bytes(value, length, order) == jbytes.int_to_bytes(value, length, order)
        assert pbytes.bytes_to_int(data, order) == jbytes.bytes_to_int(data, order)
        assert pbytes.uint64_to_bytes(value) == jbytes.uint64_to_bytes(value)
        assert pbytes.bytes32_rjust(data) == jbytes.bytes32_rjust(data)
        assert pbytes.xor_bytes(data, other) == jbytes.xor_bytes(data, other)
    for fn in (pbytes.bytes32_rjust, jbytes.bytes32_rjust):
        with pytest.raises(ValueError):
            fn(b"\x00" * 33)
    for fn in (pbytes.xor_bytes, jbytes.xor_bytes):
        with pytest.raises(ValueError):
            fn(b"\x00", b"")
    # the package re-exports them (its `retry` name is shadowed by the
    # `utils.retry` submodule once that is imported, in both packages)
    assert utils.to_hex is pbytes.to_hex and utils.with_timeout is ppromise.with_timeout


@pytest.mark.parametrize("module", [ppromise, jpromise], ids=["port", "jax"])
def test_promise_helpers(module):
    async def scenario():
        out = {}
        await module.sleep(0.001)
        abort = asyncio.Event()
        abort.set()
        try:
            await module.sleep(10, abort)
        except Exception as e:  # noqa: BLE001
            out["aborted"] = e.code
        late = asyncio.Event()
        asyncio.get_running_loop().call_later(0.01, late.set)
        try:
            await module.sleep(10, late)
        except Exception as e:  # noqa: BLE001
            out["aborted_late"] = e.code
        await module.sleep(0.001, asyncio.Event())  # not set: sleeps out
        out["value"] = await module.with_timeout(asyncio.sleep(0, result=7), 1.0)
        try:
            await module.with_timeout(asyncio.sleep(10), 0.01)
        except Exception as e:  # noqa: BLE001
            out["timeout"] = e.code
        calls = []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ValueError(f"try {len(calls)}")
            return len(calls)

        out["retried"] = await module.retry(flaky, retries=3)
        calls.clear()
        try:
            await module.retry(flaky, retries=2, retry_delay=0.001)
        except ValueError as e:
            out["gave_up"] = str(e)
        calls.clear()
        try:
            await module.retry(flaky, retries=5, should_retry=lambda e: False)
        except ValueError as e:
            out["not_retried"] = (str(e), len(calls))
        return out

    assert asyncio.run(scenario()) == {
        "aborted": "ERR_ABORTED", "aborted_late": "ERR_ABORTED", "value": 7,
        "timeout": "ERR_TIMEOUT", "retried": 3, "gave_up": "try 2", "not_retried": ("try 1", 1)}


def test_logger_injects_trace_id():
    f = TraceContextFilter()
    rec = logging.LogRecord("n", logging.INFO, "p", 1, "msg", (), None)
    f.filter(rec)
    assert rec.trace == ""  # outside any trace
    with spans.tracer.trace("log-test"):
        tid = spans.current_trace_id()
        rec2 = logging.LogRecord("n", logging.INFO, "p", 1, "msg", (), None)
        f.filter(rec2)
        assert rec2.trace == f" [t:{tid[:8]}]"


def test_get_logger_configures_no_handler():
    log = get_logger("utils-test", level=logging.DEBUG)
    assert log.name == "lodestar_tpu_torch.utils-test" and log.level == logging.DEBUG
    assert logging.getLogger("lodestar_tpu_torch").handlers == []
    assert utils.get_logger("dev") is logging.getLogger("lodestar_tpu_torch.dev")
