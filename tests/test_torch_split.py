"""The port's split verdict (`TorchBlsVerifier.verify_signature_sets` on a
batch that neither grouped planner takes whole), on the CPU.

The two compositions at reduced size: 4 sets over one shared root (4 keys)
plus 4 sets over 4 unique roots, signed by 2 keys (the rest goes
pk-grouped) or by 4 keys (the rest goes flat). Each, valid and with one
set of the unique part signing a wrong message, equals the JAX package's
CPU tier `lodestar_tpu.native.bls_verify_sets`, through the sub-paths the
planner names (spies on the submit paths).
"""

import numpy as np
import pytest
import torch

from test_torch_batch_paths import cpu_tier, make_sets, replace, root, spy_routes, verifier_cpu

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

COMPOSITIONS = {
    "pk_grouped": [0, 1, 0, 1],  # the unique part's keys
    "flat": [40, 41, 42, 43],
}


@pytest.mark.parametrize("rest", list(COMPOSITIONS))
@pytest.mark.parametrize("case", ["valid", "wrong_message"])
def test_split_verdict_equals_the_cpu_tier(rest, case):
    shared = make_sets([20, 21, 22, 23], [root(3, 0)] * 4)
    unique = make_sets(COMPOSITIONS[rest], [root(6, i) for i in range(4)])
    sets = shared + unique
    if case == "wrong_message":
        sets = replace(sets, 6, message=root(7, 7))
    v = verifier_cpu(seed=len(rest) + len(case))
    assert v._plan_groups(sets) is None and v._plan_pk_groups(sets) is None
    routes = spy_routes(v)
    got = v.verify_signature_sets(sets)
    assert routes == ["grouped", rest]
    assert got is cpu_tier(sets) is (case == "valid")
    assert np.isfinite(sum(v.stage_seconds.values()))
