"""The check that decides `correct`: every call the window made, its
verdict against the reference's.

Distinct calls (one item, its variant, one call of the unit) are judged
once whatever number of times the window made them. The calls the program
answered True are checked together, and halved only where that fails;
each call it answered False is checked on its own. Two numbers come
from here, each with the limit 0: verdicts that differ from the
reference's, and calls that returned no verdict at all (they raised, or
never came back within the drain after the window). The harness adds a
third, `host_served`, from the supervisor's counters."""

from __future__ import annotations

from collections import defaultdict

from . import bls_ref


def _sets(mix, key):
    idx, bad, ci = key
    item = (mix.bad_items if bad else mix.items)[idx]
    return item if mix.calls[ci]["sets"] == "all" else item[:1]


def check(mix, window, ref: bls_ref.Reference, seed: int = 0) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    claims = defaultdict(list)
    for r in window:
        claims[(r[2], r[3], r[1])].append(r[6])
    true_keys = [k for k, v in claims.items() if True in v]
    false_keys = [k for k, v in claims.items() if False in v]
    wrong = 0
    if true_keys and not ref.sets_pass([s for k in true_keys for s in _sets(mix, k)]):
        verdicts = ref.verify_calls([_sets(mix, k) for k in true_keys])
        wrong += sum(claims[k].count(True) for k, ok in zip(true_keys, verdicts) if not ok)
    for k, ok in zip(false_keys, ref.each_passes([_sets(mix, k) for k in false_keys], seed)):
        if ok:
            wrong += claims[k].count(False)
    missing = sum(v.count(None) for v in claims.values())
    return {"wrong_verdicts": {"value": wrong, "limit": 0},
            "missing_verdicts": {"value": missing, "limit": 0}}
