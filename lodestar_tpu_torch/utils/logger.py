"""Module-scoped loggers: the port's copy of the JAX package's
`utils/logger.py` (after the reference's `logger/winston.ts`), on stdlib
`logging`.

The port configures no handler when it is imported: a library leaves
that to its program. The CLI does it (`cli/__main__.py`), with `FORMAT`
and the `TraceContextFilter` on its handler, so every line carries the
active lifecycle trace id as the JAX package's handler does.
"""

from __future__ import annotations

import logging

FORMAT = "%(asctime)s %(levelname)-5s [%(name)s]%(trace)s %(message)s"


class TraceContextFilter(logging.Filter):
    """Inject the active lifecycle trace id (`observability.spans`) into
    every record as `trace`, so a slow-slot log line correlates with its
    `/debug/traces` entry. Outside any trace the field renders empty."""

    def filter(self, record: logging.LogRecord) -> bool:
        from ..observability.spans import current_trace_id

        tid = current_trace_id()
        record.trace = f" [t:{tid[:8]}]" if tid else ""
        return True



def get_logger(module: str, level: int | None = None) -> logging.Logger:
    """Child logger for a module (the reference's LogModule names, e.g.
    'chain', 'validator' — beacon-node/src/node/nodejs.ts:60-71)."""
    logger = logging.getLogger(f"lodestar_tpu_torch.{module}")
    if level is not None:
        logger.setLevel(level)
    return logger
