"""The observer the verifier stack calls when none is injected.

The JAX package's `observability/stages.py::PipelineMetrics` records
stage timers, planner decisions, cache and epoch-table events and
bisection outcomes into metrics families. The port calls the same
methods, at the same places, on an injected duck-typed observer (a
`PipelineMetrics` works); without one it calls `NullObserver`, whose
`stage()` is a null context and whose every other method, the
supervisor's and the dispatcher's included, does nothing.
"""

from __future__ import annotations

import contextlib


def _noop(*_args, **_kwargs) -> None:
    return None


class NullObserver:
    """Every `PipelineMetrics` method as a no-op."""

    def stage(self, _name: str):
        return contextlib.nullcontext()

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return _noop


NULL_OBSERVER = NullObserver()
