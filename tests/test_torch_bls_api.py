"""The port's `bls.api.aggregate_verify` (one C entry, a Miller loop per
pair and one final exponentiation on the host tier) and
`verify_signature_sets` (all-or-nothing over the host tier's per-set
verdicts) against the JAX package's oracle, on the same keys and
messages: the valid case and the wrong-message, reordered, short-list,
empty and infinity cases. The oracle takes about a second per call, so
the keys are few."""

import pytest

from lodestar_tpu.bls import api as jbls
from lodestar_tpu_torch.bls import api as bls

N = 3
MSGS = [bytes([0x11 * (i + 1)]) * 32 for i in range(N)]
INF_G1 = bytes([0xC0]) + bytes(47)
INF_G2 = bytes([0xC0]) + bytes(95)


def _keys(mod):
    sks = [mod.interop_secret_key(i) for i in range(N)]
    return sks, [sk.to_public_key() for sk in sks]


@pytest.fixture(scope="module")
def both():
    sks, pks = _keys(bls)
    jsks, jpks = _keys(jbls)
    assert [pk.to_bytes() for pk in pks] == [pk.to_bytes() for pk in jpks]
    sigs = [sk.sign(m) for sk, m in zip(sks, MSGS)]
    assert [s.to_bytes() for s in sigs] == [sk.sign(m).to_bytes() for sk, m in zip(jsks, MSGS)]
    agg = bls.aggregate_signatures(sigs)
    return pks, jpks, sigs, agg


AGGREGATE_CASES = {
    "valid": lambda pks, msgs, sig: (pks, msgs, sig),
    "wrong_message": lambda pks, msgs, sig: (pks, msgs[:-1] + [b"\x99" * 32], sig),
    "reordered": lambda pks, msgs, sig: (pks, msgs[::-1], sig),
    "short_list": lambda pks, msgs, sig: (pks[:-1], msgs, sig),
    "empty": lambda pks, msgs, sig: ([], [], sig),
    "subset": lambda pks, msgs, sig: (pks[:-1], msgs[:-1], sig),
}


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES))
def test_aggregate_verify_matches_the_jax_oracle(both, case):
    pks, jpks, _, agg = both
    port = bls.aggregate_verify(*AGGREGATE_CASES[case](pks, list(MSGS), agg))
    jsig = jbls.Signature.from_bytes(agg.to_bytes())
    ref = jbls.aggregate_verify(*AGGREGATE_CASES[case](jpks, list(MSGS), jsig))
    assert port is ref
    assert port is (case == "valid")


def test_aggregate_verify_refuses_infinity(both):
    pks, jpks, _, agg = both
    inf_sig = bls.Signature.from_bytes(INF_G2)
    assert bls.aggregate_verify(pks, list(MSGS), inf_sig) is False
    assert jbls.aggregate_verify(jpks, list(MSGS), jbls.Signature.from_bytes(INF_G2)) is False
    inf_pk = bls.PublicKey.from_bytes(INF_G1, validate=False)
    jinf_pk = jbls.PublicKey.from_bytes(INF_G1, validate=False)
    assert bls.aggregate_verify(pks[:-1] + [inf_pk], list(MSGS), agg) is False
    assert jbls.aggregate_verify(jpks[:-1] + [jinf_pk], list(MSGS),
                                 jbls.Signature.from_bytes(agg.to_bytes())) is False


def _sets(mod, pks, sigs, msgs):
    return [mod.SignatureSet(pk, m, s.to_bytes()) for pk, m, s in zip(pks, msgs, sigs)]


SET_CASES = {
    "valid": lambda sets: sets,
    "wrong_message": lambda sets: sets[:1] + [type(sets[1])(sets[1].pubkey, b"\x99" * 32,
                                                          sets[1].signature)] + sets[2:],
    "reordered": lambda sets: [type(s)(s.pubkey, s.message, t.signature)
                               for s, t in zip(sets, sets[1:] + sets[:1])],
    "empty": lambda sets: [],
    "infinity_signature": lambda sets: sets[:-1] + [type(sets[-1])(
        sets[-1].pubkey, sets[-1].message, INF_G2)],
}


@pytest.mark.parametrize("case", sorted(SET_CASES))
def test_verify_signature_sets_matches_the_jax_oracle(both, case):
    pks, jpks, sigs, _ = both
    port = bls.verify_signature_sets(SET_CASES[case](_sets(bls, pks, sigs, MSGS)))
    ref = jbls.verify_signature_sets(SET_CASES[case](_sets(jbls, jpks, sigs, MSGS)))
    assert port is ref
    assert port is (case == "valid")


def test_the_port_has_every_name_the_jax_module_defines():
    """Every public function and class the JAX `bls/api.py` defines (not
    the oracle names it imports) is in the port's module."""
    import inspect

    defined = {name for name, obj in vars(jbls).items()
               if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
               and obj.__module__ == jbls.__name__}
    assert {"aggregate_verify", "verify_signature_sets"} <= defined
    assert sorted(defined - set(vars(bls))) == []
