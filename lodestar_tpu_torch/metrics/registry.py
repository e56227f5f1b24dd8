"""Prometheus-style metric primitives (counter / gauge / histogram) and a
registry rendering the text exposition format — the prom-client role.

The port's own copy of the JAX package's `metrics/registry.py` (stdlib
only), so that the pipeline families render the same exposition text."""

from __future__ import annotations

import threading


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != {sorted(self.label_names)}"
            )
        return tuple(labels[k] for k in self.label_names)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self):
        for key, v in sorted(self._values.items()):
            yield dict(zip(self.label_names, key)), v

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)


class GaugeFunc(_Metric):
    """Callback gauge: the value is pulled from a function at collection
    time (prom-client's `collect()` hook) instead of being pushed with
    `set()` — queue depths and cache sizes stay live without a polling
    loop. Unlabeled by design; `set_function` allows late binding once
    the observed object exists."""

    kind = "gauge"

    def __init__(self, name, help_, fn=None):
        super().__init__(name, help_, ())
        self._fn = fn

    def set_function(self, fn) -> None:
        with self._lock:
            self._fn = fn

    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is None:
            return 0.0
        try:
            return float(fn())
        except Exception:
            return 0.0

    def collect(self):
        yield {}, self.value()


class Summary(_Metric):
    """Prometheus summary (sum + count, no quantile streams — the same
    subset prom-client exports by default without `percentiles`)."""

    kind = "summary"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._sums: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def sum(self, **labels) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def count(self, **labels) -> int:
        return self._counts.get(self._key(labels), 0)

    def time(self, **labels):
        """Context manager observing elapsed seconds."""
        import time as _time

        summ = self

        class _Timer:
            def __enter__(self):
                self.t0 = _time.perf_counter()
                return self

            def __exit__(self, *exc):
                summ.observe(_time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10)

    def __init__(self, name, help_, label_names=(), buckets=None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets) if buckets else self.DEFAULT_BUCKETS
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def time(self, **labels):
        """Context manager observing elapsed seconds."""
        import time as _time

        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = _time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(_time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()


class MetricsRegistry:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._metrics: list[_Metric] = []

    def counter(self, name, help_="", label_names=()):
        m = Counter(self.prefix + name, help_, tuple(label_names))
        self._metrics.append(m)
        return m

    def gauge(self, name, help_="", label_names=()):
        m = Gauge(self.prefix + name, help_, tuple(label_names))
        self._metrics.append(m)
        return m

    def histogram(self, name, help_="", label_names=(), buckets=None):
        m = Histogram(self.prefix + name, help_, tuple(label_names), buckets)
        self._metrics.append(m)
        return m

    def summary(self, name, help_="", label_names=()):
        m = Summary(self.prefix + name, help_, tuple(label_names))
        self._metrics.append(m)
        return m

    def gauge_func(self, name, help_="", fn=None):
        m = GaugeFunc(self.prefix + name, help_, fn)
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        for m in self._metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, counts in sorted(m._counts.items()):
                    labels = dict(zip(m.label_names, key))
                    # counts are already cumulative (observe increments
                    # every bucket >= value)
                    for b, c in zip(m.buckets, counts):
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels({**labels, 'le': repr(float(b))})} {c}"
                        )
                    total = m._totals[key]
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {total}"
                    )
                    lines.append(f"{m.name}_sum{_fmt_labels(labels)} {m._sums[key]}")
                    lines.append(f"{m.name}_count{_fmt_labels(labels)} {total}")
            elif isinstance(m, Summary):
                for key, s in sorted(m._sums.items()):
                    labels = dict(zip(m.label_names, key))
                    lines.append(f"{m.name}_sum{_fmt_labels(labels)} {s}")
                    lines.append(
                        f"{m.name}_count{_fmt_labels(labels)} {m._counts[key]}"
                    )
            else:
                for labels, v in m.collect():
                    lines.append(f"{m.name}{_fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"
