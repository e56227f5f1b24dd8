"""Generic directory-driven spec test runner.

Reference: `spec-test-util/src/single.ts` `describeDirectorySpecTest`:
walk `<suite>/<case>/` directories, load each file by extension
(`.yaml` → parsed object, `.ssz_snappy` → decompressed bytes), hand the
case's inputs to a test function, compare against expected outputs,
honour `meta.yaml` flags (e.g. bls_setting) and expected-failure cases
(no `post` file ⇒ the transition must raise).

The port's copy of the JAX package's `spec_test/runner.py`: `.yaml` files
are read by the port's `yaml_subset` (no PyYAML), `.ssz_snappy` files
decompressed by the C host tier's snappy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

from .. import native
from . import yaml_subset


@dataclass
class SpecCase:
    name: str
    directory: str
    files: dict[str, Any] = field(default_factory=dict)  # stem → content
    meta: dict = field(default_factory=dict)

    def ssz(self, stem: str) -> bytes | None:
        value = self.files.get(stem)
        return value if isinstance(value, (bytes, bytearray)) else None

    def has(self, stem: str) -> bool:
        return stem in self.files


@dataclass
class SpecTestResult:
    total: int = 0
    passed: int = 0
    failures: list[tuple[str, str]] = field(default_factory=list)

    def ok(self) -> bool:
        return self.total > 0 and not self.failures


def load_case(case_dir: str) -> SpecCase:
    case = SpecCase(name=os.path.basename(case_dir), directory=case_dir)
    for fname in sorted(os.listdir(case_dir)):
        path = os.path.join(case_dir, fname)
        if not os.path.isfile(path):
            continue
        stem, ext = fname.rsplit(".", 1)[0], fname.split(".", 1)[1]
        with open(path, "rb") as f:
            raw = f.read()
        if ext == "ssz_snappy":
            case.files[stem] = native.snappy_uncompress(raw)
        elif ext == "ssz":
            case.files[stem] = raw
        elif ext in ("yaml", "yml"):
            parsed = yaml_subset.load(raw)
            if stem == "meta":
                case.meta = parsed or {}
            else:
                case.files[stem] = parsed
    return case


def iter_cases(suite_dir: str):
    for name in sorted(os.listdir(suite_dir)):
        case_dir = os.path.join(suite_dir, name)
        if os.path.isdir(case_dir):
            yield load_case(case_dir)


def run_directory_spec_test(
    suite_dir: str,
    test_fn: Callable[[SpecCase], None],
    should_skip: Callable[[SpecCase], bool] | None = None,
) -> SpecTestResult:
    """Run `test_fn` on every case under `suite_dir`.

    `test_fn` raises AssertionError (or any exception) to fail the case;
    expected-invalid semantics live inside the per-runner functions
    (reference: each preset runner decides what a missing `post` means)."""
    result = SpecTestResult()
    for case in iter_cases(suite_dir):
        if should_skip is not None and should_skip(case):
            continue
        result.total += 1
        try:
            test_fn(case)
            result.passed += 1
        except Exception as e:  # noqa: BLE001 — collect, don't abort the suite
            result.failures.append((case.name, f"{type(e).__name__}: {e}"))
    return result
