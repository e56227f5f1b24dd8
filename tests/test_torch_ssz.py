"""The port's SSZ engine (`lodestar_tpu_torch.ssz`) and type declarations
(`lodestar_tpu_torch.types`) against the JAX package's: the same schema
built in both, random values from a numpy seed, equal serializations and
hash tree roots (tolerance: bytes equal), round trips, the incremental
`ChunkTree`, every container of `get_types` for both presets, and the
level hasher routed through the C host tier."""

import numpy as np
import pytest

from lodestar_tpu import ssz as jssz
from lodestar_tpu.params.presets import MAINNET as JMAINNET, MINIMAL as JMINIMAL
from lodestar_tpu.ssz import tree_cache as jtree
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch import ssz as pssz
from lodestar_tpu_torch.params.presets import MAINNET, MINIMAL
from lodestar_tpu_torch.ssz import hashing as phashing
from lodestar_tpu_torch.ssz import tree_cache as ptree
from lodestar_tpu_torch.types import get_types

SEED = 16


def schema(ssz):
    """One nested schema of every SSZ kind, in the package `ssz`."""
    inner = type("Inner", (ssz.Container,), {"fields": [
        ("a", ssz.uint16), ("b", ssz.Bytes32), ("c", ssz.ListType(ssz.uint8, 40))]})
    fields = [
        ("u8", ssz.uint8), ("u32", ssz.uint32), ("u64", ssz.uint64), ("u256", ssz.uint256),
        ("flag", ssz.boolean), ("root", ssz.Bytes32), ("pk", ssz.Bytes48),
        ("blob", ssz.ByteListType(100)), ("nums", ssz.ListType(ssz.uint64, 1000)),
        ("roots", ssz.VectorType(ssz.Bytes32, 5)), ("bits", ssz.BitListType(300)),
        ("vbits", ssz.BitVectorType(13)), ("inner", inner.ssz_type),
        ("inners", ssz.ListType(inner.ssz_type, 9)),
        ("choice", ssz.UnionType([None, ssz.uint64, ssz.Bytes32])),
    ]
    return type("Outer", (ssz.Container,), {"fields": fields}), inner


def random_fields(rng):
    """Field values of `schema` as plain Python values (the inner
    containers as dicts)."""
    def inner():
        return {"a": int(rng.integers(0, 2**16)), "b": rng.bytes(32),
                "c": [int(x) for x in rng.integers(0, 256, int(rng.integers(0, 41)))]}

    kind = int(rng.integers(0, 3))
    return {
        "u8": int(rng.integers(0, 256)), "u32": int(rng.integers(0, 2**32)),
        "u64": int(rng.integers(0, 2**63)) * 2 + int(rng.integers(0, 2)),
        "u256": int.from_bytes(rng.bytes(32), "little"),
        "flag": bool(rng.integers(0, 2)), "root": rng.bytes(32), "pk": rng.bytes(48),
        "blob": rng.bytes(int(rng.integers(0, 101))),
        "nums": [int(x) for x in rng.integers(0, 2**62, int(rng.integers(0, 70)))],
        "roots": [rng.bytes(32) for _ in range(5)],
        "bits": [bool(b) for b in rng.integers(0, 2, int(rng.integers(0, 301)))],
        "vbits": [bool(b) for b in rng.integers(0, 2, 13)],
        "inner": inner(),
        "inners": [inner() for _ in range(int(rng.integers(0, 10)))],
        "choice": (kind, [None, int(rng.integers(0, 2**40)), rng.bytes(32)][kind]),
    }


def build(outer, inner, fields):
    return outer(**{**fields, "inner": inner(**fields["inner"]),
                    "inners": [inner(**x) for x in fields["inners"]]})


@pytest.mark.parametrize("case", range(6))
def test_random_containers_serialize_and_hash_alike(case):
    rng = np.random.default_rng([SEED, case])
    j_outer, j_inner = schema(jssz)
    p_outer, p_inner = schema(pssz)
    fields = random_fields(rng)
    jv, pv = build(j_outer, j_inner, fields), build(p_outer, p_inner, fields)
    data = jv.serialize()
    assert pv.serialize() == data
    assert pv.hash_tree_root() == jv.hash_tree_root()
    back = p_outer.deserialize(data)
    assert back == pv and back.serialize() == data
    assert back.copy().hash_tree_root() == jv.hash_tree_root()


@pytest.mark.parametrize("limit,n", [(1, 0), (1, 1), (256, 255), (256, 256), (2048, 1000)])
def test_bitlists_and_lists_at_their_edges(limit, n):
    rng = np.random.default_rng([SEED, limit, n])
    bits = [bool(b) for b in rng.integers(0, 2, n)]
    for kind in ("bits", "u64"):
        jt = jssz.BitListType(limit) if kind == "bits" else jssz.ListType(jssz.uint64, limit)
        pt = pssz.BitListType(limit) if kind == "bits" else pssz.ListType(pssz.uint64, limit)
        value = bits if kind == "bits" else [int(x) for x in rng.integers(0, 2**63, n)]
        assert pt.serialize(value) == jt.serialize(value)
        assert pt.hash_tree_root(value) == jt.hash_tree_root(value)
        assert pt.deserialize(jt.serialize(value)) == value


def test_chunk_tree_updates_like_the_jax_one():
    rng = np.random.default_rng(SEED)
    j, p = jtree.ChunkTree(2**20), ptree.ChunkTree(2**20)
    leaves = np.frombuffer(rng.bytes(32 * 300), np.uint8).reshape(300, 32).copy()
    for step in range(4):
        if step:
            leaves[rng.integers(0, len(leaves), 7)] = np.frombuffer(
                rng.bytes(32 * 7), np.uint8).reshape(7, 32)
            leaves = np.concatenate([leaves, np.frombuffer(
                rng.bytes(32 * 5), np.uint8).reshape(5, 32)])
        p.update(leaves)
        j.update(leaves)
        assert p.root() == j.root() == phashing.merkleize_chunks(leaves.tobytes(), 2**20)


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_every_container_of_get_types_matches(preset):
    ours = get_types(MINIMAL if preset == "minimal" else MAINNET)
    theirs = jget_types(JMINIMAL if preset == "minimal" else JMAINNET)
    for fork in ("phase0", "altair", "bellatrix", "capella"):
        mine, other = vars(getattr(ours, fork)), vars(getattr(theirs, fork))
        assert sorted(mine) == sorted(other), fork
        for name, cls in mine.items():
            if not isinstance(cls, type) or not hasattr(cls, "fields"):
                continue
            assert [f for f, _ in cls.fields] == [f for f, _ in other[name].fields], name
            assert cls().serialize() == other[name]().serialize(), name
            assert cls().hash_tree_root() == other[name]().hash_tree_root(), name


def test_c_level_hasher_gives_the_same_roots():
    from lodestar_tpu_torch import native

    rng = np.random.default_rng(SEED)
    value = build(*schema(pssz), random_fields(rng))
    leaves = np.frombuffer(rng.bytes(32 * 77), np.uint8).reshape(77, 32)
    def roots():
        tree = ptree.ChunkTree(1024)
        tree.update(leaves)
        return value.hash_tree_root(), tree.root()

    want = roots()
    native.install_ssz_backend()
    try:
        assert phashing._backend_hash_level is native.sha256_level
        assert roots() == want
    finally:
        phashing.set_hash_backend(phashing.hash_level)
