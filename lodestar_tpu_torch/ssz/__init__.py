"""SSZ (SimpleSerialize) engine — equivalent of @chainsafe/ssz + as-sha256.

Common type aliases mirror the reference's primitive sszTypes
(packages/types/src/primitive/sszTypes.ts).
"""

from .core import (  # noqa: F401
    BitListType,
    BitVectorType,
    BooleanType,
    ByteListType,
    ByteVectorType,
    Container,
    ContainerType,
    DeserializationError,
    ListType,
    SSZType,
    UintType,
    UnionType,
    VectorType,
)
from .hashing import (  # noqa: F401
    ZERO_HASHES,
    hash_pair,
    merkleize_chunks,
    mix_in_length,
    set_hash_backend,
    sha256,
)

# Basic type singletons
boolean = BooleanType()
byte = UintType(1)
uint8 = UintType(1)
uint16 = UintType(2)
uint32 = UintType(4)
uint64 = UintType(8)
uint128 = UintType(16)
uint256 = UintType(32)

# Primitive aliases (reference: types/src/primitive/sszTypes.ts)
Bytes4 = ByteVectorType(4)
Bytes8 = ByteVectorType(8)
Bytes20 = ByteVectorType(20)
Bytes32 = ByteVectorType(32)
Bytes48 = ByteVectorType(48)
Bytes96 = ByteVectorType(96)

Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
SubcommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
Root = Bytes32
Version = Bytes4
DomainType = Bytes4
ForkDigest = Bytes4
Domain = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96
ExecutionAddress = Bytes20
ParticipationFlags = uint8
