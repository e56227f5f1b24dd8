"""The check catches a broken timed path: a run drives the port's own
lanes and supervisor over a device tier with a fault planted beneath
them, skipping only the look for a card, and `correct` comes out false;
with no fault it comes out true. The runs take the cell's own traffic at
its own size, on seeds picked for nothing.

Faults, as they apply to a verifier on one card: an answer altered where
it is produced (every verdict True); half of the batch left out (each
job's later half never checked); a step that returns its state unchanged
(each call of the device tier answered with its previous call's
verdict); a card that refuses
every batch, whose verdicts the supervisor's audit overturns until its
breaker opens and the host tier answers in the card's place. The exchange
between chips does not exist on one card.

A fault that leaves out a half holding no invalid set changes no verdict.
Every block window holds the invalid block, whose bad aggregate the
traffic draws from the later half of the import's first 128-set job, so
the block cell catches it on every seed. An attestation window holds one
or two invalid calls, each in either half of its lane batch as timing
falls, so the attestation cell alone catches it in about half of its
windows; `test_half_fault_in_attestation_batches` shows the fault caught
there where the small cell's many invalid calls fall in both halves.
"""

import pytest

from small import port_stack, run_small

CELLS = ["att-committees-64", "blocks-full-131"]
FAULTS = {"att-committees-64": ["altered", "unchanged", "refuses"],
          "blocks-full-131": ["altered", "half", "unchanged", "refuses"]}
SEEDS = {"att-committees-64": [2**31 + 1009], "blocks-full-131": [2**31 + 1009, 3_000_000_019]}
CASES = [(cell, fault, seed) for cell, faults in FAULTS.items() for fault in faults
         for seed in SEEDS[cell]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_stack_is_correct(monkeypatch, cell):
    result = run_small(monkeypatch, cell, 2**31 + 3, 2.0, port_stack(), full=True)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell,fault,seed", CASES)
def test_fault_is_not_correct(monkeypatch, cell, fault, seed):
    result = run_small(monkeypatch, cell, seed, 2.0, port_stack(fault), full=True)
    assert not result["correct"], result["check"]
    number = "host_served" if fault == "refuses" else "wrong_verdicts"
    assert result["check"][number]["value"] > 0


def test_half_fault_in_attestation_batches(monkeypatch):
    result = run_small(monkeypatch, "att-committees-64", 2**31 + 5, 2.0, port_stack("half"))
    assert not result["correct"], result["check"]
    assert result["check"]["wrong_verdicts"]["value"] > 0
