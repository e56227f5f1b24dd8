"""The port's pk-grouped and flat batch verdicts and the rest of the batch
planner (`parallel/verifier.py`), on the CPU.

- The planner takes the JAX package's order, root-grouped → pk-grouped →
  split → flat, on batches made for each branch (spies on the submit
  paths, the verdict kernels stubbed); a batch outside the 32 B root /
  96 B signature shape goes flat with host-decoded signatures; grouped
  lane counts must be multiples of 4.
- `_marshal_pk_grouped` and `_marshal(raw=True)` give the arrays of the
  JAX package's `_marshal_pk_grouped(raw=True)` and `_marshal(raw=True)`;
  the pooled hashing gives the arrays of the unpooled one.
- `verify_signature_sets(device="cpu")` at the pk-grouped (4, 4)
  configuration (8 sets over 8 unique roots from 2 keys) and on a flat
  batch of 4 unique sets equals the JAX package's CPU tier
  `lodestar_tpu.native.bls_verify_sets`, valid and tampered, through the
  path the planner names.
- Slow tier: `pk_grouped_verify_kernel_raw` and `batch_verify_kernel_raw`
  of the port against the JAX kernels on inputs carried over by
  `convert.pk_grouped_inputs_from_jax` / `flat_inputs_from_jax`, under the
  same random bits.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.parallel.verifier import TpuBlsVerifier
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.parallel import verifier
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier, _rand_bits, _rand_pairs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

PK_CONFIG = (4, 4)


def make_sets(keys, roots):
    """Sets signed by interop key keys[i] over roots[i]."""
    out = []
    for k, root in zip(keys, roots):
        sk = bls.interop_secret_key(k)
        out.append(bls.SignatureSet(pubkey=sk.to_public_key(), message=root,
                                    signature=jnative.bls_sign(sk.to_bytes(), root, DST_G2)[1]))
    return out


def root(tag: int, i: int) -> bytes:
    return bytes([tag, i]) * 16


def pk_sets():
    """8 sets over 8 unique roots from 2 keys: pk-grouped, 2 runs of 4."""
    return make_sets([i % 2 for i in range(8)], [root(1, i) for i in range(8)])


def flat_sets():
    """4 sets over 4 roots from 4 keys: flat, bucket 4."""
    return make_sets([10 + i for i in range(4)], [root(2, i) for i in range(4)])


def replace(sets, k, **fields):
    out = list(sets)
    s = sets[k]
    parts = {"pubkey": s.pubkey, "message": s.message, "signature": s.signature}
    parts.update(fields)
    out[k] = bls.SignatureSet(**parts)
    return out


def bad_flags(sets, k):
    raw = bytearray(sets[k].signature)
    raw[0] &= 0x7F  # compression flag cleared: does not decode
    return replace(sets, k, signature=bytes(raw))


def cpu_tier(sets) -> bool:
    return all(jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), bls.DST_G2,
    ))


def verifier_cpu(seed=0):
    return TorchBlsVerifier(device="cpu", grouped_configs=((2, 4),),
                            pk_grouped_configs=(PK_CONFIG,), rng=np.random.default_rng(seed))


def spy_routes(v):
    routes = []
    for name in ("_submit_grouped", "_submit_pk_grouped", "_submit_flat"):
        fn = getattr(v, name)

        def spy(*args, _fn=fn, _name=name[len("_submit_"):]):
            routes.append(_name)
            return _fn(*args)

        setattr(v, name, spy)
    return routes


@pytest.fixture
def stub_kernels(monkeypatch):
    """The three batch-verdict kernels answer True at once: the planner
    and the marshalling run for real."""
    for name in ("grouped_verify_kernel_raw", "pk_grouped_verify_kernel_raw",
                 "batch_verify_kernel_raw", "batch_verify_kernel"):
        monkeypatch.setattr(verifier, name, lambda *a, **k: torch.tensor(True))


def test_planner_takes_the_jax_order(stub_kernels):
    shared = make_sets([20, 21, 22, 23], [root(3, 0)] * 4)  # one root, 4 keys
    cases = {
        "grouped": (shared, ["grouped"]),
        "pk_grouped": (pk_sets(), ["pk_grouped"]),
        "flat": (flat_sets(), ["flat"]),
        # 4 shared-root sets + 4 unique roots from 2 keys, then from 4 keys
        "split_pk": (shared + make_sets([0, 1, 0, 1], [root(4, i) for i in range(4)]),
                     ["grouped", "pk_grouped"]),
        "split_flat": (shared + flat_sets(), ["grouped", "flat"]),
    }
    for name, (sets, want) in cases.items():
        v = verifier_cpu()
        routes = spy_routes(v)
        assert v.verify_signature_sets(sets) is True, name
        assert routes == want, name
        if name != "grouped":
            assert v._plan_groups(sets) is None, name
    # outside the root / signature shape: flat, signatures decoded on the host
    v = verifier_cpu()
    routes = spy_routes(v)
    long_msg = make_sets([30, 31], [b"m" * 40, b"n" * 40])
    assert v.verify_signature_sets(long_msg) is True and routes == ["flat"]
    assert v.verify_signature_sets([]) is False


def test_grouped_lanes_must_be_multiples_of_four():
    with pytest.raises(ValueError):
        TorchBlsVerifier(device="cpu", pk_grouped_configs=((4, 6),))
    with pytest.raises(ValueError):
        TorchBlsVerifier(device="cpu", grouped_configs=((2, 3),))


def test_marshal_matches_the_jax_marshal():
    jv = TpuBlsVerifier(buckets=(4, 16, 64, 128), grouped_configs=((2, 4),),
                        pk_grouped_configs=(PK_CONFIG,), mesh=None)
    sets = pk_sets()
    plan = verifier_cpu()._plan_pk_groups(sets)
    assert plan == jv._plan_pk_groups(sets)
    g, sig_raw = verifier_cpu()._marshal_pk_grouped(sets, plan)
    jg, jraw = jv._marshal_pk_grouped(sets, plan, raw=True)
    for name in ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y", "valid"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name), err_msg=name)
    np.testing.assert_array_equal(sig_raw, jraw)
    assert g.n == jg.n == len(sets)

    sets = flat_sets()[:3]
    arrs, sig_raw = verifier_cpu()._marshal(sets, raw=True)
    jarrs, jraw = jv._marshal(sets, raw=True)
    for name in ("pk_x", "pk_y", "msg_x", "msg_y", "valid"):
        np.testing.assert_array_equal(getattr(arrs, name), getattr(jarrs, name), err_msg=name)
    np.testing.assert_array_equal(sig_raw, jraw)


def test_pooled_hashing_gives_the_unpooled_arrays(monkeypatch):
    sets = make_sets([i % 2 for i in range(16)], [root(5, i) for i in range(16)])
    config = ((2, 8),)
    plain = TorchBlsVerifier(device="cpu", pk_grouped_configs=config)
    want = plain._marshal_pk_grouped(sets, plain._plan_pk_groups(sets))
    # a chunk of 4 sets makes 16 sets four pool tasks
    monkeypatch.setattr(verifier, "_MARSHAL_CHUNK", 4)
    monkeypatch.setattr(verifier, "marshal_pool_size", lambda: 4)
    pool = verifier._marshal_pool()
    submitted = []
    orig_submit = pool.submit
    monkeypatch.setattr(pool, "submit", lambda *a: submitted.append(a[1:]) or orig_submit(*a))
    pooled = TorchBlsVerifier(device="cpu", pk_grouped_configs=config)
    got = pooled._marshal_pk_grouped(sets, pooled._plan_pk_groups(sets))
    assert submitted == [(0, 4), (4, 8), (8, 12), (12, 16)]
    for name in ("pk_x", "pk_y", "msg_x", "msg_y", "valid"):
        np.testing.assert_array_equal(getattr(got[0], name), getattr(want[0], name), err_msg=name)
    np.testing.assert_array_equal(got[1], want[1])


PK_CASES = ["valid", "wrong_message", "bad_flags"]


def pk_batch(case):
    sets = pk_sets()
    if case == "wrong_message":
        return replace(sets, 5, message=root(9, 9))
    if case == "bad_flags":
        return bad_flags(sets, 2)
    return sets


@pytest.mark.parametrize("case", PK_CASES)
def test_pk_grouped_verdict_equals_the_cpu_tier(case):
    sets = pk_batch(case)
    v = verifier_cpu(seed=PK_CASES.index(case))
    routes = spy_routes(v)
    got = v.verify_signature_sets(sets)
    assert routes == ["pk_grouped"]
    assert got is cpu_tier(sets) is (case == "valid")


FLAT_CASES = ["valid", "swapped_signature"]


@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_verdict_equals_the_cpu_tier(case):
    sets = flat_sets()
    if case == "swapped_signature":
        sets = replace(replace(sets, 1, signature=sets[3].signature), 3,
                       signature=sets[1].signature)
    v = verifier_cpu(seed=10 + FLAT_CASES.index(case))
    routes = spy_routes(v)
    got = v.verify_signature_sets(sets)
    assert routes == ["flat"]
    assert got is cpu_tier(sets) is (case == "valid")


@pytest.mark.slow
def test_pk_grouped_kernel_raw_matches_jax():
    import jax
    import jax.numpy as jnp

    from lodestar_tpu.parallel import verifier as jver
    from lodestar_tpu_torch.convert import pk_grouped_inputs_from_jax

    jv = TpuBlsVerifier(grouped_configs=((2, 4),), pk_grouped_configs=(PK_CONFIG,), mesh=None)
    kernel = jax.jit(jver.pk_grouped_verify_kernel_raw)
    for k, case in enumerate(PK_CASES):
        sets = pk_batch(case)
        g, sig_raw = jv._marshal_pk_grouped(sets, jv._plan_pk_groups(sets), raw=True)
        a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(k))
        ref = kernel(jnp.asarray(g.pk_x), jnp.asarray(g.pk_y), jnp.asarray(g.msg_x),
                     jnp.asarray(g.msg_y), jnp.asarray(sig_raw), jnp.asarray(a_bits),
                     jnp.asarray(b_bits), jnp.asarray(g.valid))
        got = verifier.pk_grouped_verify_kernel_raw(
            *pk_grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits))
        assert bool(got) == bool(ref) == (case == "valid"), case


@pytest.mark.slow
def test_batch_kernel_raw_matches_jax():
    import jax
    import jax.numpy as jnp

    from lodestar_tpu.parallel import verifier as jver
    from lodestar_tpu_torch.convert import flat_inputs_from_jax

    jv = TpuBlsVerifier(buckets=(4,), mesh=None)
    kernel = jax.jit(jver.batch_verify_kernel_raw)
    for k, case in enumerate(FLAT_CASES):
        sets = flat_sets()
        if case == "swapped_signature":
            sets = replace(replace(sets, 1, signature=sets[3].signature), 3,
                           signature=sets[1].signature)
        arrs, sig_raw = jv._marshal(sets, raw=True)
        r_bits = _rand_bits(4, np.random.default_rng(k))
        ref = kernel(jnp.asarray(arrs.pk_x), jnp.asarray(arrs.pk_y), jnp.asarray(arrs.msg_x),
                     jnp.asarray(arrs.msg_y), jnp.asarray(sig_raw), jnp.asarray(r_bits),
                     jnp.asarray(arrs.valid))
        got = verifier.batch_verify_kernel_raw(*flat_inputs_from_jax(arrs, sig_raw, r_bits))
        assert bool(got) == bool(ref) == (case == "valid"), case
