"""Paths and the `card` marker for the benchmark's own tests.

    python -m pytest benchmark/tests -q            # on a machine without a card
    python -m pytest benchmark/tests -q -m card    # on a machine with a card
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
