"""SSZ type system: serialization, deserialization, merkleization.

Equivalent role of `@chainsafe/ssz` for the reference (SURVEY.md §2.1 `types`):
implements the SimpleSerialize spec — basic uints/boolean, byte vectors/lists,
bit vectors/lists, vectors, lists, containers, unions — with offset-based
variable-size serialization and `hash_tree_root` merkleization (pack,
merkleize with limit, length mix-in).

Values are plain Python objects (int, bool, bytes, list, Container instances)
rather than tree-backed views; the state-transition layer keeps its own flat
numpy caches for the hot paths (reference keeps ViewDU trees + flat caches,
state-transition/src/cache/*).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

from .hashing import (
    ZERO_HASHES,
    merkleize_chunks,
    mix_in_length,
    mix_in_selector,
)

BYTES_PER_CHUNK = 32
OFFSET_SIZE = 4


class DeserializationError(ValueError):
    pass


def _pack_bytes_to_chunks(data: bytes) -> bytes:
    if len(data) % BYTES_PER_CHUNK:
        data = data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return data


class SSZType:
    """Base type descriptor. Instances describe a type; values are plain."""

    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def serialize(self, value: Any) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes) -> Any:
        raise NotImplementedError

    def hash_tree_root(self, value: Any) -> bytes:
        raise NotImplementedError

    def default(self) -> Any:
        raise NotImplementedError

    # JSON-ish representation for the REST API layer
    def to_obj(self, value: Any) -> Any:
        raise NotImplementedError

    def from_obj(self, obj: Any) -> Any:
        raise NotImplementedError

    def min_size(self) -> int:
        return self.fixed_size() if self.is_fixed_size() else 0

    def equals(self, a: Any, b: Any) -> bool:
        return self.serialize(a) == self.serialize(b)


class UintType(SSZType):
    def __init__(self, byte_length: int):
        assert byte_length in (1, 2, 4, 8, 16, 32)
        self.byte_length = byte_length
        self._max = (1 << (8 * byte_length)) - 1

    def __repr__(self) -> str:
        return f"uint{self.byte_length * 8}"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.byte_length

    def serialize(self, value: int) -> bytes:
        v = int(value)
        if v < 0 or v > self._max:
            raise ValueError(f"uint{self.byte_length*8} out of range: {value}")
        return v.to_bytes(self.byte_length, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.byte_length:
            raise DeserializationError(f"uint{self.byte_length*8}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value: int) -> bytes:
        return int(value).to_bytes(self.byte_length, "little") + b"\x00" * (32 - self.byte_length)

    def default(self) -> int:
        return 0

    def to_obj(self, value: int) -> str:
        return str(int(value))

    def from_obj(self, obj: Any) -> int:
        return int(obj)


class BooleanType(SSZType):
    def __repr__(self) -> str:
        return "boolean"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return 1

    def serialize(self, value: bool) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise DeserializationError(f"boolean: invalid byte {data!r}")

    def hash_tree_root(self, value: bool) -> bytes:
        return (b"\x01" if value else b"\x00") + b"\x00" * 31

    def default(self) -> bool:
        return False

    def to_obj(self, value: bool) -> bool:
        return bool(value)

    def from_obj(self, obj: Any) -> bool:
        return bool(obj)


class ByteVectorType(SSZType):
    def __init__(self, length: int):
        self.length = length

    def __repr__(self) -> str:
        return f"ByteVector[{self.length}]"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.length

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: bad length {len(value)}")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise DeserializationError(f"ByteVector[{self.length}]: bad length {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        return merkleize_chunks(_pack_bytes_to_chunks(self.serialize(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length

    def to_obj(self, value: bytes) -> str:
        return "0x" + bytes(value).hex()

    def from_obj(self, obj: str) -> bytes:
        return bytes.fromhex(obj[2:] if obj.startswith("0x") else obj)


class ByteListType(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self) -> str:
        return f"ByteList[{self.limit}]"

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: too long {len(value)}")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise DeserializationError(f"ByteList[{self.limit}]: too long {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: too long {len(value)}")
        limit_chunks = (self.limit + 31) // 32
        root = merkleize_chunks(_pack_bytes_to_chunks(value), limit=limit_chunks)
        return mix_in_length(root, len(value))

    def default(self) -> bytes:
        return b""

    def to_obj(self, value: bytes) -> str:
        return "0x" + bytes(value).hex()

    def from_obj(self, obj: str) -> bytes:
        return bytes.fromhex(obj[2:] if obj.startswith("0x") else obj)


class BitVectorType(SSZType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def __repr__(self) -> str:
        return f"BitVector[{self.length}]"

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return (self.length + 7) // 8

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"BitVector[{self.length}]: bad length {len(value)}")
        return _bits_to_bytes(value)

    def deserialize(self, data: bytes) -> list[bool]:
        if len(data) != self.fixed_size():
            raise DeserializationError(f"BitVector[{self.length}]: bad byte length {len(data)}")
        bits = _bytes_to_bits(data)
        # Check padding bits beyond `length` are zero
        if any(bits[self.length :]):
            raise DeserializationError(f"BitVector[{self.length}]: nonzero padding")
        return bits[: self.length]

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        return merkleize_chunks(
            _pack_bytes_to_chunks(self.serialize(value)), limit=(self.length + 255) // 256
        )

    def default(self) -> list[bool]:
        return [False] * self.length

    def to_obj(self, value: Sequence[bool]) -> str:
        return "0x" + self.serialize(value).hex()

    def from_obj(self, obj: str) -> list[bool]:
        return self.deserialize(bytes.fromhex(obj[2:] if obj.startswith("0x") else obj))


class BitListType(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self) -> str:
        return f"BitList[{self.limit}]"

    def is_fixed_size(self) -> bool:
        return False

    def min_size(self) -> int:
        return 1

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"BitList[{self.limit}]: too long {len(value)}")
        # Append the delimiter bit at position len(value)
        bits = list(value) + [True]
        return _bits_to_bytes(bits)

    def deserialize(self, data: bytes) -> list[bool]:
        if len(data) == 0:
            raise DeserializationError("BitList: empty")
        if data[-1] == 0:
            raise DeserializationError("BitList: missing delimiter bit")
        bits = _bytes_to_bits(data)
        # Find the delimiter: highest set bit
        last = len(bits) - 1
        while not bits[last]:
            last -= 1
        bit_len = last
        if bit_len > self.limit:
            raise DeserializationError(f"BitList[{self.limit}]: too long {bit_len}")
        # Delimiter must be within the final byte
        if len(data) != (bit_len // 8) + 1:
            raise DeserializationError("BitList: excess bytes")
        return bits[:bit_len]

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"BitList[{self.limit}]: too long {len(value)}")
        data = _bits_to_bytes(list(value))  # no delimiter in merkleization
        root = merkleize_chunks(_pack_bytes_to_chunks(data), limit=(self.limit + 255) // 256)
        return mix_in_length(root, len(value))

    def default(self) -> list[bool]:
        return []

    def to_obj(self, value: Sequence[bool]) -> str:
        return "0x" + self.serialize(value).hex()

    def from_obj(self, obj: str) -> list[bool]:
        return self.deserialize(bytes.fromhex(obj[2:] if obj.startswith("0x") else obj))


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        if bit:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _bytes_to_bits(data: bytes) -> list[bool]:
    return [bool((byte >> j) & 1) for byte in data for j in range(8)]


class _HomogeneousType(SSZType):
    """Shared machinery for Vector/List of arbitrary element types."""

    elem: SSZType

    def _serialize_elems(self, values: Iterable[Any]) -> bytes:
        elem = self.elem
        if elem.is_fixed_size():
            return b"".join(elem.serialize(v) for v in values)
        parts = [elem.serialize(v) for v in values]
        offset = OFFSET_SIZE * len(parts)
        out = bytearray()
        for p in parts:
            out += offset.to_bytes(OFFSET_SIZE, "little")
            offset += len(p)
        for p in parts:
            out += p
        return bytes(out)

    def _deserialize_elems(self, data: bytes) -> list[Any]:
        elem = self.elem
        if elem.is_fixed_size():
            size = elem.fixed_size()
            if len(data) % size:
                raise DeserializationError(f"{self}: byte length {len(data)} not multiple of {size}")
            return [elem.deserialize(data[i : i + size]) for i in range(0, len(data), size)]
        if len(data) == 0:
            return []
        if len(data) < OFFSET_SIZE:
            raise DeserializationError(f"{self}: truncated offsets")
        first_offset = int.from_bytes(data[:OFFSET_SIZE], "little")
        if first_offset == 0 or first_offset % OFFSET_SIZE or first_offset > len(data):
            raise DeserializationError(f"{self}: bad first offset {first_offset}")
        count = first_offset // OFFSET_SIZE
        offsets = [
            int.from_bytes(data[i * OFFSET_SIZE : (i + 1) * OFFSET_SIZE], "little")
            for i in range(count)
        ]
        offsets.append(len(data))
        values = []
        for i in range(count):
            if offsets[i] > offsets[i + 1]:
                raise DeserializationError(f"{self}: decreasing offsets")
            values.append(elem.deserialize(data[offsets[i] : offsets[i + 1]]))
        return values

    def _chunks(self, values: Sequence[Any]) -> bytes:
        elem = self.elem
        if isinstance(elem, (UintType, BooleanType)):
            return _pack_bytes_to_chunks(b"".join(elem.serialize(v) for v in values))
        return b"".join(elem.hash_tree_root(v) for v in values)

    def _chunk_limit(self, length: int) -> int:
        elem = self.elem
        if isinstance(elem, (UintType, BooleanType)):
            return (length * elem.fixed_size() + 31) // 32
        return length


class VectorType(_HomogeneousType):
    def __init__(self, elem: SSZType, length: int):
        assert length > 0
        self.elem = elem
        self.length = length

    def __repr__(self) -> str:
        return f"Vector[{self.elem!r}, {self.length}]"

    def is_fixed_size(self) -> bool:
        return self.elem.is_fixed_size()

    def fixed_size(self) -> int:
        return self.elem.fixed_size() * self.length

    def serialize(self, value: Sequence[Any]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"{self}: bad length {len(value)}")
        return self._serialize_elems(value)

    def deserialize(self, data: bytes) -> list[Any]:
        values = self._deserialize_elems(data)
        if len(values) != self.length:
            raise DeserializationError(f"{self}: bad element count {len(values)}")
        return values

    def hash_tree_root(self, value: Sequence[Any]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"{self}: bad length {len(value)}")
        return merkleize_chunks(self._chunks(value), limit=self._chunk_limit(self.length))

    def default(self) -> list[Any]:
        return [self.elem.default() for _ in range(self.length)]

    def to_obj(self, value: Sequence[Any]) -> list[Any]:
        return [self.elem.to_obj(v) for v in value]

    def from_obj(self, obj: Sequence[Any]) -> list[Any]:
        return [self.elem.from_obj(v) for v in obj]


class ListType(_HomogeneousType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def __repr__(self) -> str:
        return f"List[{self.elem!r}, {self.limit}]"

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: Sequence[Any]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"{self}: too long {len(value)}")
        return self._serialize_elems(value)

    def deserialize(self, data: bytes) -> list[Any]:
        values = self._deserialize_elems(data)
        if len(values) > self.limit:
            raise DeserializationError(f"{self}: too long {len(values)}")
        return values

    def hash_tree_root(self, value: Sequence[Any]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"{self}: too long {len(value)}")
        root = merkleize_chunks(self._chunks(value), limit=self._chunk_limit(self.limit))
        return mix_in_length(root, len(value))

    def default(self) -> list[Any]:
        return []

    def to_obj(self, value: Sequence[Any]) -> list[Any]:
        return [self.elem.to_obj(v) for v in value]

    def from_obj(self, obj: Sequence[Any]) -> list[Any]:
        return [self.elem.from_obj(v) for v in obj]


class Container:
    """Base class for container *values*. Subclasses set ``fields`` as a list
    of (name, SSZType) pairs; a matching ContainerType is auto-attached as
    ``cls.ssz_type`` (reference: per-fork ContainerTypes in
    packages/types/src/*/sszTypes.ts)."""

    fields: list[tuple[str, SSZType]] = []
    ssz_type: "ContainerType"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.__dict__.get("fields"):
            cls.ssz_type = ContainerType(cls.fields, value_class=cls)

    def __init__(self, **kwargs: Any):
        field_names = {name for name, _ in self.fields}
        for name, typ in self.fields:
            if name in kwargs:
                setattr(self, name, kwargs[name])
            else:
                setattr(self, name, typ.default())
        unknown = set(kwargs) - field_names
        if unknown:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(unknown)}")

    @classmethod
    def default(cls) -> "Container":
        return cls()

    def serialize(self) -> bytes:
        return self.ssz_type.serialize(self)

    def hash_tree_root(self) -> bytes:
        return self.ssz_type.hash_tree_root(self)

    @classmethod
    def deserialize(cls, data: bytes) -> "Container":
        return cls.ssz_type.deserialize(data)

    def copy(self) -> "Container":
        """Deep copy through non-destructive structural copying."""
        out = type(self).__new__(type(self))
        for name, typ in self.fields:
            out.__dict__[name] = _copy_value(typ, getattr(self, name))
        return out

    def to_obj(self) -> dict:
        return self.ssz_type.to_obj(self)

    @classmethod
    def from_obj(cls, obj: dict) -> "Container":
        return cls.ssz_type.from_obj(obj)

    def __eq__(self, other: object) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n) for n, _ in self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n, _ in self.fields[:4])
        more = "..." if len(self.fields) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"


def _copy_value(typ: SSZType, value: Any) -> Any:
    if isinstance(value, Container):
        return value.copy()
    if isinstance(value, list):
        elem = getattr(typ, "elem", None)
        if elem is not None:
            return [_copy_value(elem, v) for v in value]
        return list(value)
    return value  # int/bytes/bool are immutable


class ContainerType(SSZType):
    def __init__(self, fields: list[tuple[str, SSZType]], value_class: type | None = None):
        self.fields = fields
        self.value_class = value_class
        self._fixed = all(t.is_fixed_size() for _, t in fields)
        self._fixed_part_size = sum(
            t.fixed_size() if t.is_fixed_size() else OFFSET_SIZE for _, t in fields
        )

    def __repr__(self) -> str:
        name = self.value_class.__name__ if self.value_class else "Container"
        return f"ContainerType[{name}]"

    def is_fixed_size(self) -> bool:
        return self._fixed

    def fixed_size(self) -> int:
        if not self._fixed:
            raise TypeError(f"{self} is variable-size")
        return self._fixed_part_size

    def min_size(self) -> int:
        return self._fixed_part_size

    def _get(self, value: Any, name: str) -> Any:
        return getattr(value, name) if not isinstance(value, dict) else value[name]

    def serialize(self, value: Any) -> bytes:
        fixed_parts: list[bytes | None] = []
        variable_parts: list[bytes] = []
        for name, typ in self.fields:
            v = self._get(value, name)
            if typ.is_fixed_size():
                fixed_parts.append(typ.serialize(v))
            else:
                fixed_parts.append(None)
                variable_parts.append(typ.serialize(v))
        offset = self._fixed_part_size
        out = bytearray()
        var_i = 0
        for part in fixed_parts:
            if part is None:
                out += offset.to_bytes(OFFSET_SIZE, "little")
                offset += len(variable_parts[var_i])
                var_i += 1
            else:
                out += part
        for part in variable_parts:
            out += part
        return bytes(out)

    def deserialize(self, data: bytes) -> Any:
        if len(data) < self._fixed_part_size:
            raise DeserializationError(f"{self}: truncated ({len(data)} bytes)")
        values: dict[str, Any] = {}
        pos = 0
        offsets: list[tuple[str, SSZType, int]] = []
        for name, typ in self.fields:
            if typ.is_fixed_size():
                size = typ.fixed_size()
                values[name] = typ.deserialize(data[pos : pos + size])
                pos += size
            else:
                offset = int.from_bytes(data[pos : pos + OFFSET_SIZE], "little")
                offsets.append((name, typ, offset))
                pos += OFFSET_SIZE
        if offsets:
            if offsets[0][2] != self._fixed_part_size:
                raise DeserializationError(f"{self}: first offset {offsets[0][2]} != fixed size")
            ends = [o for _, _, o in offsets[1:]] + [len(data)]
            for (name, typ, start), end in zip(offsets, ends):
                if start > end or end > len(data):
                    raise DeserializationError(f"{self}: invalid offsets")
                values[name] = typ.deserialize(data[start:end])
        elif pos != len(data):
            raise DeserializationError(f"{self}: {len(data) - pos} excess bytes")
        if self.value_class is not None:
            return self.value_class(**values)
        return values

    def hash_tree_root(self, value: Any) -> bytes:
        chunks = b"".join(typ.hash_tree_root(self._get(value, name)) for name, typ in self.fields)
        return merkleize_chunks(chunks)

    def field_index(self, field_name: str) -> int:
        for i, (name, _) in enumerate(self.fields):
            if name == field_name:
                return i
        raise KeyError(field_name)

    def get_field_branch(self, value: Any, field_name: str) -> list[bytes]:
        """Merkle sibling path proving `field_name`'s root against this
        container's hash_tree_root (bottom-up). Compose paths for nested
        fields by concatenation: inner branch first, then outer."""
        _, branches = self.get_field_branches(value, [field_name])
        return branches[field_name]

    def get_field_branches(
        self, value: Any, field_names: list[str]
    ) -> tuple[bytes, dict[str, list[bytes]]]:
        """(container root, {field: branch}) computed from ONE pass over the
        field roots — callers proving several fields (light-client server)
        must not re-merkleize the container per field."""
        from .hashing import merkle_branch

        chunks = [
            typ.hash_tree_root(self._get(value, name)) for name, typ in self.fields
        ]
        root = merkleize_chunks(b"".join(chunks))
        branches = {
            name: merkle_branch(chunks, self.field_index(name))
            for name in field_names
        }
        return root, branches

    def default(self) -> Any:
        if self.value_class is not None:
            return self.value_class()
        return {name: typ.default() for name, typ in self.fields}

    def to_obj(self, value: Any) -> dict:
        return {name: typ.to_obj(self._get(value, name)) for name, typ in self.fields}

    def from_obj(self, obj: dict) -> Any:
        values = {name: typ.from_obj(obj[name]) for name, typ in self.fields}
        if self.value_class is not None:
            return self.value_class(**values)
        return values


class UnionType(SSZType):
    """SSZ Union (selector byte + value). Option 0 may be None."""

    def __init__(self, options: list[SSZType | None]):
        assert len(options) >= 1
        # Spec rule: None is only permitted as option 0 (and then there must
        # be at least one more option).
        if any(t is None for t in options[1:]) or (options[0] is None and len(options) < 2):
            raise TypeError("Union: None only allowed as first of >=2 options")
        self.options = options

    def is_fixed_size(self) -> bool:
        return False

    def min_size(self) -> int:
        return 1

    def serialize(self, value: tuple[int, Any]) -> bytes:
        selector, v = value
        typ = self.options[selector]
        if typ is None:
            if v is not None:
                raise ValueError("Union None option with value")
            return bytes([selector])
        return bytes([selector]) + typ.serialize(v)

    def deserialize(self, data: bytes) -> tuple[int, Any]:
        if not data:
            raise DeserializationError("Union: empty")
        selector = data[0]
        if selector >= len(self.options):
            raise DeserializationError(f"Union: bad selector {selector}")
        typ = self.options[selector]
        if typ is None:
            if len(data) != 1:
                raise DeserializationError("Union: excess bytes for None option")
            return (selector, None)
        return (selector, typ.deserialize(data[1:]))

    def hash_tree_root(self, value: tuple[int, Any]) -> bytes:
        selector, v = value
        typ = self.options[selector]
        root = ZERO_HASHES[0] if typ is None else typ.hash_tree_root(v)
        return mix_in_selector(root, selector)

    def default(self) -> tuple[int, Any]:
        typ = self.options[0]
        return (0, None if typ is None else typ.default())

    def to_obj(self, value: tuple[int, Any]) -> dict:
        selector, v = value
        typ = self.options[selector]
        return {"selector": selector, "value": None if typ is None else typ.to_obj(v)}

    def from_obj(self, obj: dict) -> tuple[int, Any]:
        selector = int(obj["selector"])
        typ = self.options[selector]
        return (selector, None if typ is None else typ.from_obj(obj["value"]))
