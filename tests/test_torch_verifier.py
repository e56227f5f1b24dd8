"""The port's root-grouped batch verdict (`parallel/verifier.py`).

- The planner (`_plan_runs`) gives the plans of the JAX package's
  `TpuBlsVerifier._plan_runs` (a static method: no compile) on random
  root multisets.
- `TorchBlsVerifier(device="cpu")` at the (2, 4) configuration answers
  True on a valid batch and False on four tampered ones (a wrong message,
  swapped signatures, swapped pubkeys, a bad encoding), each equal to the
  JAX package's CPU tier `lodestar_tpu.native.bls_verify_sets`.
- A batch the grouped planner refuses no longer raises: it goes on down
  the planner (here to the flat verdict; `test_torch_batch_paths.py`
  checks that path's verdicts), and an empty batch is False.
- Slow tier: `grouped_verify_kernel_raw` of the port against the JAX one
  under the same random bits on the five batches, verdict for verdict.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import native as jnative
from lodestar_tpu.bls import api as bls
from lodestar_tpu.parallel.verifier import TpuBlsVerifier
from lodestar_tpu_torch.bls.api import DST_G2
from lodestar_tpu_torch.bls.fields import P
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier, _rand_pairs

# several pytest workers share the host: one intra-op thread each keeps
# OpenMP from spinning against the others
torch.set_num_threads(1)

ROOTS, PER_ROOT = 2, 4


def _valid_sets():
    sets = []
    for r in range(ROOTS):
        root = bytes([0x5A ^ r]) * 32
        for k in range(PER_ROOT):
            sk = bls.interop_secret_key(r * PER_ROOT + k)
            sets.append(bls.SignatureSet(
                pubkey=sk.to_public_key(), message=root,
                signature=jnative.bls_sign(sk.to_bytes(), root, DST_G2)[1],
            ))
    return sets


def _swap(sets, i, j, field):
    out = list(sets)
    a, b = sets[i], sets[j]
    vals = {f: (getattr(a, f), getattr(b, f)) for f in ("pubkey", "message", "signature")}
    va, vb = vals[field]
    vals[field] = (vb, va)
    out[i] = bls.SignatureSet(pubkey=vals["pubkey"][0], message=vals["message"][0],
                              signature=vals["signature"][0])
    out[j] = bls.SignatureSet(pubkey=vals["pubkey"][1], message=vals["message"][1],
                              signature=vals["signature"][1])
    return out


def _bad_encoding(sets, i):
    out = list(sets)
    raw = bytearray(sets[i].signature)
    pb = bytearray(P.to_bytes(48, "big"))
    pb[0] |= 0x80 | (raw[0] & 0x20)  # x.c1 = p under valid flags
    raw[:48] = pb
    out[i] = bls.SignatureSet(pubkey=sets[i].pubkey, message=sets[i].message,
                              signature=bytes(raw))
    return out


def _batches():
    """(name, sets): the valid batch and four tampered ones, each keeping
    the multiset of roots so the planner keeps the (2, 4) layout."""
    valid = _valid_sets()
    i, j = 1, PER_ROOT + 2  # sets of the two different roots
    return [
        ("valid", valid),
        ("wrong_message", _swap(valid, i, j, "message")),
        ("swapped_signature", _swap(valid, i, j, "signature")),
        ("swapped_pubkey", _swap(valid, i, j, "pubkey")),
        ("bad_encoding", _bad_encoding(valid, i)),
    ]


def _cpu_tier(sets):
    ok = jnative.bls_verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), bls.DST_G2,
    )
    return all(ok)


def test_plans_match_the_jax_planner():
    rng = np.random.default_rng(1)
    configs = ((2, 4), (16, 8), (64, 64))
    for trial in range(200):
        n = int(rng.integers(1, 300))
        n_keys = int(rng.integers(1, 80))
        keys = [bytes([int(k)]) * 32 for k in rng.integers(0, n_keys, size=n)]
        ours = TorchBlsVerifier._plan_runs(keys, configs)
        assert ours == TpuBlsVerifier._plan_runs(keys, configs), trial


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.mark.parametrize("case", range(5))
def test_verdict_equals_the_cpu_tier(batches, case):
    name, sets = batches[case]
    v = TorchBlsVerifier(device="cpu", grouped_configs=((ROOTS, PER_ROOT),),
                         rng=np.random.default_rng(case))
    assert v._plan_groups(sets)[:2] == (ROOTS, PER_ROOT)
    got = v.verify_signature_sets(sets)
    assert got is _cpu_tier(sets), name
    assert got is (name == "valid")


def test_ungroupable_batch_raises(batches, monkeypatch):
    # a batch neither grouped planner takes goes on to the flat path
    _, sets = batches[0]
    v = TorchBlsVerifier(device="cpu", grouped_configs=((ROOTS, PER_ROOT),))
    unique = [bls.SignatureSet(pubkey=s.pubkey, message=bytes([k]) * 32, signature=s.signature)
              for k, s in enumerate(sets)]
    assert v._plan_groups(unique) is None and v._plan_pk_groups(unique) is None
    flat = []
    monkeypatch.setattr(v, "_submit_flat", lambda sets: flat.append(sets) or (lambda: "flat"))
    assert v.verify_signature_sets(unique) == "flat"
    assert flat == [unique]
    monkeypatch.undo()
    assert v.verify_signature_sets([]) is False


def test_rand_pairs_default_is_unpredictable_and_in_range():
    a1, b1 = _rand_pairs((2, 4))
    a2, b2 = _rand_pairs((2, 4))
    assert a1.shape == b1.shape == (2, 4, 32)
    assert set(np.unique(np.concatenate([a1, b1]))) <= {0, 1}
    assert not (np.array_equal(a1, a2) and np.array_equal(b1, b2))
    # a callable as in the JAX package: 64-bit words split as (low, high)
    words = iter([0, 5 | (7 << 32)])
    a, b = _rand_pairs((2,), lambda: next(words))
    assert a[0, 0] == 1 and b[0].sum() == 0  # (0, 0) is excluded
    assert int("".join(map(str, a[1][::-1])), 2) == 5
    assert int("".join(map(str, b[1][::-1])), 2) == 7


@pytest.mark.slow
def test_grouped_kernel_raw_matches_jax(batches):
    import jax
    import jax.numpy as jnp

    from lodestar_tpu.parallel import verifier as jver
    from lodestar_tpu_torch.convert import grouped_inputs_from_jax
    from lodestar_tpu_torch.parallel.verifier import grouped_verify_kernel_raw

    jv = TpuBlsVerifier(grouped_configs=((ROOTS, PER_ROOT),), mesh=None)
    kernel = jax.jit(jver.grouped_verify_kernel_raw)
    for k, (name, sets) in enumerate(batches):
        plan = jv._plan_groups(sets)
        g, sig_raw = jv._marshal_grouped(sets, plan, raw=True)
        a_bits, b_bits = _rand_pairs(g.valid.shape, np.random.default_rng(k))
        ref = kernel(jnp.asarray(g.pk_x), jnp.asarray(g.pk_y), jnp.asarray(g.msg_x),
                     jnp.asarray(g.msg_y), jnp.asarray(sig_raw), jnp.asarray(a_bits),
                     jnp.asarray(b_bits), jnp.asarray(g.valid))
        got = grouped_verify_kernel_raw(*grouped_inputs_from_jax(g, sig_raw, a_bits, b_bits))
        assert isinstance(got, torch.Tensor)
        assert bool(got) == bool(ref) == (name == "valid"), name
