"""The control comes out not correct: the reference in the program's place
with one guarantee broken (`standins.ControlStack`), at a size a test run
holds. On the card's machine `control.py` runs it at the cell's own size."""

import pytest

from small import run_small


def _control(kind):
    import random

    from bm import bls_ref, standins

    return lambda mix: standins.ControlStack(kind, bls_ref.Reference(random.Random(9)))


@pytest.mark.parametrize("cell,kind", [("att-committees-64", "batch_verdict"),
                                       ("blocks-full-131", "first_set")])
def test_control_is_not_correct(monkeypatch, cell, kind):
    result = run_small(monkeypatch, cell, 2**31 + 21, 3.0, _control(kind))
    assert not result["correct"], result["check"]
    assert result["check"]["wrong_verdicts"]["value"] > 0
