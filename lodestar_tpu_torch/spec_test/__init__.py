"""Spec-test harness (equivalent of `packages/spec-test-util`).

Reference: `spec-test-util/src/single.ts` (`describeDirectorySpecTest` —
a generic directory-driven test runner over the official
`ethereum/consensus-spec-tests` fixture layout) and `downloadTests`
(`src/downloadTests.ts:35`).

This environment has no network egress, so instead of a downloader the
harness ships a *generator* (`fixtures.py`) that writes suites in the
official directory layout (`<config>/<fork>/<runner>/<handler>/<suite>/
<case>/{pre,post,...}.ssz_snappy + meta.yaml`) from chain states built
by this implementation — the runner (`runner.py`) consumes that layout
exactly as it would consume the official tarballs, so dropping in real
vectors requires zero code changes.

The port's copy of the JAX package's `spec_test/`; its YAML is the
port's own `yaml_subset`, so importing it loads no PyYAML.
"""

from .runner import SpecCase, SpecTestResult, run_directory_spec_test  # noqa: F401
from .presets import (  # noqa: F401
    run_epoch_processing_suite,
    run_operations_suite,
    run_sanity_blocks_suite,
    run_sanity_slots_suite,
    run_shuffling_suite,
)
