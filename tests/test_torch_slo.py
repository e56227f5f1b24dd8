"""The port's SLO engine (`observability/slo.py`) against the JAX
package's: both engines, each over its package's `PipelineMetrics`, fed
the same events under the same fake clock, give the same states, burn
rates and budgets (to 1e-9) and export the same `lodestar_slo_*` lines;
the packaged rules equal `dashboards/slo_rules.json`; every rule's
source family is registered by the port's pipeline; the process-wide
singleton, its rate-limited `poke()` and the supervisor's poke."""

import json
import os

import pytest

from lodestar_tpu.observability import slo as jax_slo
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu_torch.observability import slo as port_slo
from lodestar_tpu_torch.observability.stages import PipelineMetrics as PortPipeline

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RULES = os.path.join(REPO, "dashboards", "slo_rules.json")


@pytest.fixture(autouse=True)
def _no_engine():
    port_slo._reset_for_tests()
    yield
    port_slo._reset_for_tests()


class Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def test_packaged_rules_equal_the_dashboards_file():
    with open(RULES, encoding="utf-8") as f:
        original = json.load(f)
    with open(port_slo.DEFAULT_RULES_PATH, encoding="utf-8") as f:
        assert json.load(f) == original
    assert port_slo.load_rules()["objectives"] == original["objectives"]


def test_every_source_family_is_registered():
    names = {m.name for m in PortPipeline().registry._metrics}
    for obj in port_slo.load_rules()["objectives"]:
        assert obj["source"] in names, obj["name"]
    # and none reports absent
    eng = port_slo.SloEngine(PortPipeline(), clock=Clock())
    assert {r["state"] for r in eng.evaluate()} == {"ok"}


# each step: (seconds to advance, [(method, args, kwargs), ...])
SCRIPT = [
    (1.0, [("flush", ("size",), {"latency_s": 0.2}), ("flush", ("timer",), {"latency_s": 0.7})]),
    (60.0, [("breaker_state", (2,), {"to": "open"}), ("compile_event", ("k", "hit", 1.0), {}),
            ("compile_event", ("k", "miss", 2.0), {})]),
    (120.0, [("lane_shed", ("block", 1), {}), ("serving_ready", (12.5,), {})]),
    (200.0, [("breaker_state", (0,), {"to": "closed"}), ("verdict_mismatch", (), {}),
             ("flush", ("size",), {"latency_s": 0.1})]),
    (400.0, [("both_tiers_failed", (), {}), ("lane_shed", ("attestation", 5), {})]),
    (3700.0, [("flush", ("size",), {"latency_s": 0.05})]),
    (10.0, []),
]


def slo_lines(p) -> list[str]:
    return sorted(ln for ln in p.registry.expose().splitlines() if ln.startswith("lodestar_slo_"))


def drive(mod, pipeline_cls):
    p = pipeline_cls()
    clock = Clock()
    eng = mod.SloEngine(p, clock=clock)
    reports = [eng.evaluate()]
    for dt, events in SCRIPT:
        clock.t += dt
        for name, args, kw in events:
            getattr(p, name)(*args, **kw)
        reports.append(eng.evaluate())
    snap = eng.snapshot()
    snap.pop("rules_path")
    return reports, snap, slo_lines(p)


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= 1e-9
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def test_same_states_budgets_and_exports():
    jax = drive(jax_slo, JaxPipeline)
    port = drive(port_slo, PortPipeline)
    assert _close(port[0], jax[0])
    assert _close(port[1], jax[1])
    assert port[2] == jax[2]
    # the script burns what it should, and the burn clears once the short
    # window goes quiet
    after_shed = {r["name"]: r for r in port[0][3]}
    assert after_shed["zero_block_sheds"]["state"] == "burning"
    assert after_shed["serving_ready"]["budget_remaining"] == 0.0
    final = {r["name"]: r for r in port[0][-1]}
    assert final["zero_block_sheds"]["state"] == "ok"


def test_install_snapshot_uninstall_and_poke_rate_limit():
    assert port_slo.snapshot_or_none() is None
    p = PortPipeline()
    eng = port_slo.install(p, poke_interval_s=3600.0)
    assert port_slo.engine() is eng
    snap = port_slo.snapshot_or_none()
    assert snap["rules_path"] == port_slo.DEFAULT_RULES_PATH
    assert snap["burning"] == []
    before = snap["evaluations"]
    port_slo.poke()  # the first poke evaluates
    port_slo.poke()  # rate-limited
    with eng._lock:
        assert eng._evaluations == before + 1
    port_slo.uninstall(object())  # not the installed engine: kept
    assert port_slo.engine() is eng
    port_slo.uninstall(eng)
    assert port_slo.engine() is None
    port_slo.poke()  # no engine: nothing to do, no error


def test_supervisor_failure_pokes_the_engine():
    """The breaker opening (exceptions from the device) re-evaluates the
    installed engine at once: `breaker_closed` goes ok → burning."""
    from lodestar_tpu_torch.chain.bls_verifier import MockBlsVerifier
    from lodestar_tpu_torch.chain.supervisor import SupervisedBlsVerifier

    class Failing:
        observer = None

        def verify_signature_sets(self, sets):
            raise RuntimeError("device down")

    p = PortPipeline()
    eng = port_slo.install(p, poke_interval_s=0.0)
    sup = SupervisedBlsVerifier(Failing(), MockBlsVerifier(), observer=p, failure_threshold=1,
                                retries=0, canary_thread=False)
    try:
        assert sup.verify_signature_sets([object()]) is True  # the host tier serves
    finally:
        sup.close()
    assert p.slo_burning.value(objective="breaker_closed") == 1
    assert "breaker_closed" in eng.snapshot()["burning"]
