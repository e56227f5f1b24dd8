"""Declarative SLO engine: objectives → error budgets → burn alerts (the
JAX package's `observability/slo.py`).

- The objectives are the port's own copy of the JAX package's
  `dashboards/slo_rules.json`, shipped beside this module
  (`slo_rules.json`; a test holds the two equal): name, source metric
  family, SLI kind, threshold and target, runbook link.
- Each evaluation reads the SLI straight out of the live
  `PipelineMetrics` registry and appends a cumulative (bad, total)
  sample to a bounded per-objective history.
- Burn state is multi-window: an objective is `burning` only when both
  the short (5 min) and the long (1 h) window exceed its
  `burn_threshold`. Zero-tolerance objectives (target 1.0,
  counter_zero) burn on any bad event above `allowed` in both windows.
- Results export as the `lodestar_slo_*` families on the pipeline and
  serve `/debug/slo`.

SLI kinds (each yields cumulative good/bad/total event counts):

    counter_zero     bad = counter sum over an optional label subset;
                     zero tolerance (any bad above `allowed` burns)
    histogram_under  good = observations <= `threshold` (largest bucket
                     boundary <= threshold), total = all observations
    gauge_under      one sample per evaluation: good while the gauge
                     reads <= `threshold`; an unset gauge contributes no
                     sample (a node that never reported cannot burn)
    label_ratio      good/bad = counter sums over `good_label` /
                     `bad_label` subsets (e.g. build cache hit/miss)

The JAX module reads its rules path (LODESTAR_TPU_SLO_RULES) and poke
interval (LODESTAR_TPU_SLO_POKE_S) from the environment; here they are
arguments of `load_rules` and `install`. It never raises into the
serving path: `poke()` swallows and records evaluation errors.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import flight_recorder

__all__ = [
    "SloEngine",
    "load_rules",
    "install",
    "engine",
    "poke",
    "snapshot_or_none",
    "DEFAULT_RULES_PATH",
    "POKE_INTERVAL_S",
    "uninstall",
    "VALID_KINDS",
]

DEFAULT_RULES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slo_rules.json")
POKE_INTERVAL_S = 1.0  # the JAX package's LODESTAR_TPU_SLO_POKE_S default

VALID_KINDS = ("counter_zero", "histogram_under", "gauge_under", "label_ratio")

# bounded per-objective history: at one sample per scrape/poke this
# covers the 1 h long window with plenty of slack
MAX_SAMPLES = 4096

_EPS = 1e-9


def load_rules(path: str | None = None) -> dict:
    """Load + validate a rules file (default: the packaged copy); raises
    ValueError on a malformed document."""
    if path is None:
        path = DEFAULT_RULES_PATH
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    validate_rules(doc)
    doc["_path"] = path
    return doc


def validate_rules(doc: dict) -> None:
    """The rules document's schema check."""
    if not isinstance(doc, dict):
        raise ValueError("rules document is not a JSON object")
    windows = doc.get("windows")
    if not isinstance(windows, dict):
        raise ValueError("rules document has no `windows` object")
    for key in ("short_s", "long_s"):
        if not isinstance(windows.get(key), (int, float)) or windows[key] <= 0:
            raise ValueError(f"windows.{key} must be a positive number")
    if windows["short_s"] >= windows["long_s"]:
        raise ValueError("windows.short_s must be < windows.long_s")
    objectives = doc.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        raise ValueError("rules document has no objectives")
    seen: set[str] = set()
    for obj in objectives:
        if not isinstance(obj, dict):
            raise ValueError("objective entries must be JSON objects")
        name = obj.get("name")
        if not name or not isinstance(name, str):
            raise ValueError("objective without a name")
        if name in seen:
            raise ValueError(f"duplicate objective name {name!r}")
        seen.add(name)
        if not obj.get("source"):
            raise ValueError(f"objective {name!r} has no source metric")
        kind = obj.get("kind")
        if kind not in VALID_KINDS:
            raise ValueError(
                f"objective {name!r} has unknown kind {kind!r} "
                f"(valid: {', '.join(VALID_KINDS)})"
            )
        if kind in ("histogram_under", "gauge_under") and not isinstance(
            obj.get("threshold"), (int, float)
        ):
            raise ValueError(f"objective {name!r} ({kind}) needs a numeric "
                             "threshold")
        if kind == "label_ratio":
            for key in ("good_label", "bad_label"):
                if not isinstance(obj.get(key), dict):
                    raise ValueError(
                        f"objective {name!r} (label_ratio) needs {key}"
                    )


def _labels_match(labels: dict, subset: dict | None) -> bool:
    if not subset:
        return True
    return all(labels.get(k) == str(v) for k, v in subset.items())


def _find_metric(registry, name: str):
    for m in registry._metrics:
        if m.name == name:
            return m
    return None


class _Objective:
    """One objective's spec + bounded sample history + burn state."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.name = spec["name"]
        self.kind = spec["kind"]
        self.source = spec["source"]
        self.target = float(spec.get("target", 1.0))
        self.threshold = float(spec.get("threshold", 0.0))
        self.burn_threshold = float(spec.get("burn_threshold", 1.0))
        self.allowed = float(spec.get("allowed", 0))
        self.budget = max(0.0, 1.0 - self.target)
        # cumulative (t, bad, total) samples, oldest first
        self.samples: deque[tuple] = deque(maxlen=MAX_SAMPLES)
        self.state: str | None = None
        # gauge_under keeps its own cumulative sample counters (the
        # gauge itself has no event count to delta)
        self.gauge_bad = 0
        self.gauge_total = 0

    # -- SLI readers (cumulative good/bad/total) ---------------------------

    def read(self, registry) -> tuple[float, float] | None:
        """Cumulative (bad, total) event counts, or None when the source
        metric is absent from the registry."""
        metric = _find_metric(registry, self.source)
        if metric is None:
            return None
        reader = getattr(self, f"_read_{self.kind}")
        return reader(metric)

    def _read_counter_zero(self, metric):
        bad = sum(
            v for labels, v in metric.collect()
            if _labels_match(labels, self.spec.get("labels"))
        )
        return bad, bad

    def _read_histogram_under(self, metric):
        idx = None
        for i, b in enumerate(metric.buckets):
            if b <= self.threshold + _EPS:
                idx = i
        good = 0
        total = 0
        subset = self.spec.get("labels")
        for key, counts in list(metric._counts.items()):
            labels = dict(zip(metric.label_names, key))
            if not _labels_match(labels, subset):
                continue
            if idx is not None:
                good += counts[idx]
            total += metric._totals.get(key, 0)
        return float(total - good), float(total)

    def _read_gauge_under(self, metric):
        value = None
        for labels, v in metric.collect():
            if _labels_match(labels, self.spec.get("labels")):
                value = v if value is None else max(value, v)
        if value is not None:
            self.gauge_total += 1
            if value > self.threshold + _EPS:
                self.gauge_bad += 1
        return float(self.gauge_bad), float(self.gauge_total)

    def _read_label_ratio(self, metric):
        good = sum(
            v for labels, v in metric.collect()
            if _labels_match(labels, self.spec["good_label"])
        )
        bad = sum(
            v for labels, v in metric.collect()
            if _labels_match(labels, self.spec["bad_label"])
        )
        return float(bad), float(good + bad)

    # -- burn math ---------------------------------------------------------

    def _window_delta(self, now: float, window_s: float) -> tuple[float, float]:
        """(bad, total) accrued inside the trailing window: newest sample
        minus the anchor (latest sample at least `window_s` old, falling
        back to the oldest — a young engine reports its whole history)."""
        newest = self.samples[-1]
        anchor = self.samples[0]
        for sample in self.samples:
            if now - sample[0] >= window_s - _EPS:
                anchor = sample
            else:
                break
        return newest[1] - anchor[1], newest[2] - anchor[2]

    def _burn_rate(self, bad: float, total: float) -> float:
        if self.budget > _EPS:
            if total <= 0:
                return 0.0
            return (bad / total) / self.budget
        # zero-tolerance: the "rate" is the raw bad-event count
        return float(bad)

    def _is_burning(self, rate_short: float, rate_long: float) -> bool:
        if self.budget > _EPS:
            return (rate_short >= self.burn_threshold
                    and rate_long >= self.burn_threshold)
        return rate_short > self.allowed and rate_long > self.allowed

    def budget_remaining(self) -> float:
        """Fraction of the error budget left since the engine started."""
        first, last = self.samples[0], self.samples[-1]
        bad = last[1] - first[1]
        total = last[2] - first[2]
        if self.budget > _EPS:
            if total <= 0:
                return 1.0
            return max(0.0, min(1.0, 1.0 - (bad / total) / self.budget))
        return 1.0 if bad <= self.allowed else 0.0


class SloEngine:
    """Evaluates the committed objectives over a live PipelineMetrics."""

    def __init__(self, pipeline, rules: dict | None = None,
                 rules_path: str | None = None, clock=time.monotonic):
        if rules is None:
            rules = load_rules(rules_path)
        else:
            validate_rules(rules)
        self._pipeline = pipeline
        self._clock = clock
        self._lock = threading.Lock()
        self._rules_path = rules.get("_path")
        self.short_s = float(rules["windows"]["short_s"])
        self.long_s = float(rules["windows"]["long_s"])
        self._objectives = [_Objective(o) for o in rules["objectives"]]  # guarded-by: _lock
        self._evaluations = 0  # guarded-by: _lock
        # baseline sample: budgets start full at engine install, so
        # pre-engine history (e.g. warmup compiles) doesn't page
        self.evaluate()

    def objectives(self) -> list[str]:
        return [o.name for o in self._objectives]

    def evaluate(self) -> list[dict]:
        """One evaluation pass: sample every objective, update burn
        state, export the `lodestar_slo_*` families. Returns the
        per-objective reports."""
        now = self._clock()
        reports = []
        with self._lock:
            self._evaluations += 1
            for obj in self._objectives:
                reports.append(self._evaluate_one_locked(obj, now))
        pipeline = self._pipeline
        if pipeline is not None:
            pipeline.slo_evaluated()
            for rep in reports:
                if rep["state"] == "absent":
                    continue
                pipeline.slo_report(
                    rep["name"], rep["state"] == "burning",
                    rep["budget_remaining"], rep["burn_rate_short"],
                    rep["burn_rate_long"],
                )
        return reports

    def _evaluate_one_locked(self, obj: _Objective, now: float) -> dict:
        sli = obj.read(self._pipeline.registry) if self._pipeline else None
        base = {
            "name": obj.name,
            "description": obj.spec.get("description", ""),
            "kind": obj.kind,
            "source": obj.source,
            "target": obj.target,
            "runbook": obj.spec.get("runbook", ""),
        }
        if sli is None:
            # source family missing from this registry (partial wiring):
            # report, don't crash (a test holds every source family present)
            base.update(state="absent", burn_rate_short=0.0,
                        burn_rate_long=0.0, budget_remaining=1.0,
                        bad_events=0, total_events=0)
            return base
        bad, total = sli
        obj.samples.append((now, bad, total))
        bad_s, total_s = obj._window_delta(now, self.short_s)
        bad_l, total_l = obj._window_delta(now, self.long_s)
        rate_short = obj._burn_rate(bad_s, total_s)
        rate_long = obj._burn_rate(bad_l, total_l)
        state = "burning" if obj._is_burning(rate_short, rate_long) else "ok"
        if obj.state is not None and state != obj.state:
            flight_recorder.record(
                "slo_transition", objective=obj.name, state=state,
                burn_short=round(rate_short, 4),
                burn_long=round(rate_long, 4),
            )
        obj.state = state
        first = obj.samples[0]
        base.update(
            state=state,
            burn_rate_short=round(rate_short, 4),
            burn_rate_long=round(rate_long, 4),
            budget_remaining=round(obj.budget_remaining(), 4),
            bad_events=bad - first[1],
            total_events=total - first[2],
        )
        return base

    def snapshot(self) -> dict:
        """The `/debug/slo` document (evaluates first, so
        every read is live)."""
        reports = self.evaluate()
        with self._lock:
            evaluations = self._evaluations
        return {
            "rules_path": self._rules_path,
            "windows": {"short_s": self.short_s, "long_s": self.long_s},
            "evaluations": evaluations,
            "burning": sorted(
                r["name"] for r in reports if r["state"] == "burning"
            ),
            "objectives": reports,
        }


# -- process-wide singleton ---------------------------------------------------

_engine: SloEngine | None = None
_engine_lock = threading.Lock()
# None (not 0.0): monotonic() starts near zero on a fresh boot, so a
# zero sentinel would rate-limit the very first poke of the process
_last_poke: float | None = None
_poke_s = POKE_INTERVAL_S


def install(pipeline, rules: dict | None = None,
            rules_path: str | None = None, clock=time.monotonic,
            poke_interval_s: float = POKE_INTERVAL_S) -> SloEngine:
    """Create the process-wide engine over `pipeline` (replaces any prior
    install: the serving stack and the warm-boot ladder each install over
    the pipeline they serve). `poke()` re-evaluates at most once per
    `poke_interval_s` (0: every poke)."""
    global _engine, _poke_s
    eng = SloEngine(pipeline, rules=rules, rules_path=rules_path, clock=clock)
    with _engine_lock:
        _engine = eng
        _poke_s = poke_interval_s
    return eng


def uninstall(eng: SloEngine | None = None) -> None:
    """Drop the process-wide engine (only `eng`, when given and still the
    installed one)."""
    global _engine
    with _engine_lock:
        if eng is None or _engine is eng:
            _engine = None


def engine() -> SloEngine | None:
    """The installed engine, or None — never creates one (an engine
    without a deliberately chosen pipeline would judge nothing)."""
    with _engine_lock:
        return _engine


def snapshot_or_none() -> dict | None:
    """`/debug/slo` provider: None while no engine is installed."""
    eng = engine()
    return eng.snapshot() if eng is not None else None


def poke() -> None:
    """Event-driven re-evaluation from the supervisor's device-failure
    path: rate-limited by the installed `poke_interval_s` and never raises
    into the caller."""
    global _last_poke
    eng = engine()
    if eng is None:
        return
    now = time.monotonic()
    with _engine_lock:
        min_s = _poke_s
        if min_s and _last_poke is not None and now - _last_poke < min_s:
            return
        _last_poke = now
    try:
        eng.evaluate()
    except Exception as e:
        flight_recorder.record("slo_poke_error", error=str(e))


def _reset_for_tests() -> None:
    global _engine, _last_poke, _poke_s
    with _engine_lock:
        _engine = None
        _last_poke = None
        _poke_s = POKE_INTERVAL_S
