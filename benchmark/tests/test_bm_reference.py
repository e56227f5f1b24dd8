"""The reference against the frozen signer: valid sets verify, tampered
ones do not, and H(m) is the signer's."""

import random

import pytest

from bm import bls_ref as b
from bm import signer


def _sets(n, roots=3, seed=5):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        sk = rng.randrange(1, b.R)
        root = bytes([i % roots]) * 32
        out.append((signer.sk_to_pk(sk), root, signer.sign(sk, root)))
    return out


def test_generators_and_hash_match_the_signer():
    assert signer.sk_to_pk(1) == b.g1_compress(b.G1)
    for m in (b"\x00" * 32, bytes(range(32))):
        assert signer.sign(1, m) == b.g2_compress(b.hash_to_g2(m))


def test_decompress_round_trip():
    for pk, _, sig in _sets(3):
        assert b.g1_compress(b.g1_decompress(pk)) == pk
        assert b.g2_compress(b.g2_decompress(sig)) == sig


def test_g2_subgroup_check():
    _, _, sig = _sets(1)[0]
    x, y = b.g2_decompress(sig)
    assert b.g2_in_subgroup((x, y, b.ONE2))
    # a point of E' outside G2: the first x with a square x³ + 4(1+i)
    for x0 in range(1, 50):
        y2 = b.f2_add(b.f2_mul(b.f2_sqr((x0, 1)), (x0, 1)), b.B2)
        y = b.f2_sqrt(y2)
        if y is not None:
            break
    pt = ((x0, 1), y, b.ONE2)
    assert not b.g2_in_subgroup(pt)
    assert b.g2_in_subgroup(b.g2_clear_cofactor(pt))


def test_valid_sets_verify_and_tampered_do_not():
    sets = _sets(6)
    ref = b.Reference(random.Random(1))
    assert ref.sets_pass(sets)
    wrong_root = (sets[0][0], bytes([9]) * 32, sets[0][2])
    wrong_key = (sets[1][0], sets[0][1], sets[0][2])
    swapped = (sets[0][0], sets[0][1], sets[3][2])
    not_a_point = (sets[0][0], sets[0][1], b"\xff" * 96)
    for bad in (wrong_root, wrong_key, swapped, not_a_point):
        assert not ref.sets_pass([bad])
        assert not ref.sets_pass(sets[:3] + [bad])


@pytest.mark.parametrize("workers", [1, 2])
def test_verify_calls_finds_each_invalid_call(workers):
    import multiprocessing

    sets = _sets(7)
    bad = (sets[0][0], sets[0][1], sets[1][2])
    calls = [[s] for s in sets[:3]] + [[bad]] + [[s] for s in sets[3:]] + [sets[:2]]
    pool = multiprocessing.get_context("spawn").Pool(workers) if workers > 1 else None
    try:
        ref = b.Reference(random.Random(2), pool)
        assert ref.verify_calls(calls) == [True] * 3 + [False] + [True] * 5
        assert ref.each_passes(calls, 3) == [True] * 3 + [False] + [True] * 5
    finally:
        if pool is not None:
            pool.close()
            pool.join()
