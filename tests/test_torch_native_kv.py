"""The port's native KV engine (`csrc/host/kvstore.c` through `native.kv_*`
and `db.controller.NativeKvDb`) against the JAX package's: the same
script of puts, deletes, batches, ranges and compactions gives equal
gets, ranges and `stats()`; a datadir written by either package reads
back in the other, also across segments and after compaction; a torn
tail is dropped on replay in both; concurrent readers and a compacting
writer do not crash; the engine's compaction crash windows, its gate and
its sealed-segment read cache behave as the JAX tests pin them."""

import os
import shutil
import threading

import numpy as np
import pytest

from lodestar_tpu.db.controller import NativeKvDb as JaxKvDb
from lodestar_tpu_torch import native
from lodestar_tpu_torch.db.controller import NativeKvDb

SEED = 20


def _script(seed: int = SEED):
    """A seeded list of operations: ("put", k, v), ("delete", k),
    ("batch", [(k, v), ...]), ("compact",)."""
    rng = np.random.default_rng(seed)
    keys = [bytes([0x10 + (i % 3)]) + rng.bytes(int(rng.integers(1, 12))) for i in range(40)]
    ops = []
    for step in range(300):
        r = rng.random()
        k = keys[int(rng.integers(len(keys)))]
        if r < 0.55:
            ops.append(("put", k, rng.bytes(int(rng.integers(0, 6000)))))
        elif r < 0.75:
            ops.append(("delete", k))
        elif r < 0.95:
            ops.append(("batch", [(keys[int(i)], rng.bytes(int(rng.integers(0, 300))))
                                  for i in rng.integers(len(keys), size=5)]))
        else:
            ops.append(("compact",))
    return keys, ops


def _apply(db, op) -> None:
    if op[0] == "put":
        db.put(op[1], op[2])
    elif op[0] == "delete":
        db.delete(op[1])
    elif op[0] == "batch":
        db.batch_put(op[1])
    else:
        db.compact()


def _view(db, keys):
    """Everything the controller answers: gets, three ranges, stats."""
    return {
        "gets": [db.get(k) for k in keys],
        "all": list(db.entries_stream(b"", b"")),
        "range": list(db.keys_stream(b"\x11", b"\x12")),
        "values": list(db.values_stream(b"\x10", b"\x12")),
        "stats": db.stats(),
    }


def test_kv_script_equal_in_both_packages(tmp_path):
    """The same seeded script through both engines: equal answers after
    every 50 operations, and after a reopen of each."""
    keys, ops = _script()
    port, jax_ = NativeKvDb(str(tmp_path / "port")), JaxKvDb(str(tmp_path / "jax"))
    try:
        for i, op in enumerate(ops):
            _apply(port, op)
            _apply(jax_, op)
            if i % 50 == 49:
                assert _view(port, keys) == _view(jax_, keys), f"after operation {i}"
    finally:
        port.close()
        jax_.close()
    port, jax_ = NativeKvDb(str(tmp_path / "port")), JaxKvDb(str(tmp_path / "jax"))
    try:
        got, want = _view(port, keys), _view(jax_, keys)
        assert got == want and got["stats"]["entries"] > 0
    finally:
        port.close()
        jax_.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_datadir_crosses_packages(tmp_path, monkeypatch, writer):
    """A datadir written by one package (several segments, deletes, a
    compaction, then more writes) opens in the other with equal contents
    and stats, and the other's writes read back in the first."""
    monkeypatch.setenv("LODESTAR_KV_SEG_LIMIT", "8192")  # the JAX engine's test hook
    keys, ops = _script(SEED + 1)
    path = str(tmp_path / "kv")
    make = {"jax": JaxKvDb, "port": lambda p: NativeKvDb(p, seg_limit=8192)}
    other = "port" if writer == "jax" else "jax"
    db = make[writer](path)
    for op in ops:
        _apply(db, op)
    want = _view(db, keys)
    db.close()
    assert want["stats"]["active_segment"] > 0  # the script spans segments
    db = make[other](path)
    try:
        assert _view(db, keys) == want
        db.put(b"\x20from-" + other.encode(), b"written by the other package")
        db.delete(keys[0])
        want = _view(db, keys + [b"\x20from-" + other.encode()])
    finally:
        db.close()
    db = make[writer](path)
    try:
        assert _view(db, keys + [b"\x20from-" + other.encode()]) == want
    finally:
        db.close()


@pytest.mark.parametrize("cut", [1, 3, 9])
def test_torn_tail_dropped_on_replay(tmp_path, cut):
    """A segment cut inside its last record: both engines keep every whole
    record and drop the torn one, with equal stats. A quirk both copies
    share (ROADMAP Queue 3): the torn bytes stay in the active segment, so
    a record appended after them is served until the next open, whose
    replay stops at the torn record and loses it."""
    path = str(tmp_path / "kv")
    db = NativeKvDb(path)
    db.put(b"good", b"value")
    db.put(b"other", b"x" * 100)
    db.put(b"later", b"value2")
    db.close()
    seg = os.path.join(path, "seg-00000.kv")
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - cut)
    shutil.copytree(path, str(tmp_path / "jax"))
    port, jax_ = NativeKvDb(path), JaxKvDb(str(tmp_path / "jax"))
    try:
        for db in (port, jax_):
            assert db.get(b"good") == b"value" and db.get(b"other") == b"x" * 100
            assert db.get(b"later") is None
            db.put(b"after", b"tail")
            assert db.get(b"after") == b"tail"
        assert port.stats() == jax_.stats()
    finally:
        port.close()
        jax_.close()
    port, jax_ = NativeKvDb(path), JaxKvDb(str(tmp_path / "jax"))
    try:
        for db in (port, jax_):
            assert db.get(b"good") == b"value" and db.get(b"after") is None
        assert port.stats() == jax_.stats()
    finally:
        port.close()
        jax_.close()


def test_concurrent_readers_and_compacting_writer(tmp_path):
    """Four reader threads against a writer that overwrites, deletes and
    compacts (across segments): no crash, no torn value (every value read
    is one the writer wrote for that key), and the final state is the
    writer's."""
    db = NativeKvDb(str(tmp_path / "kv"), seg_limit=16384)
    keys = [b"k%02d" % i for i in range(16)]
    versions = {k: [bytes([i]) * 700 for i in range(30)] for k in keys}
    for k in keys:
        db.put(k, versions[k][0])
    stop = threading.Event()
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                k = keys[int(rng.integers(len(keys)))]
                v = db.get(k)
                if v is not None and v not in versions[k]:
                    errors.append((k, v[:4]))
                list(db.keys_stream(b"k0", b"k1"))
                db.stats()
        except Exception as e:  # noqa: BLE001 — any raise is a failure
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        for r in range(1, 30):
            for k in keys:
                db.put(k, versions[k][r])
            db.delete(keys[r % len(keys)])
            if r % 5 == 0:
                db.compact()
    finally:
        stop.set()
        for t in threads:
            t.join()
    try:
        assert errors == []
        assert db.get(keys[29 % len(keys)]) is None
        assert db.get(keys[0]) == versions[keys[0]][29]
        assert db.stats()["entries"] == len(keys) - 1
    finally:
        db.close()


def test_compaction_crash_windows_recoverable(tmp_path):
    """The swap protocol, as the JAX engine's test pins it: .new files with
    no marker are discarded; a marker with .new files finishes the
    promotion on open."""
    path = str(tmp_path / "kv")
    db = NativeKvDb(path)
    for i in range(10):
        db.put(f"k{i}".encode(), f"v{i}".encode())
    db.close()
    stray = os.path.join(path, "seg-00001.kv.new")
    with open(stray, "wb") as f:
        f.write(b"\x00" * 64)
    db = NativeKvDb(path)
    assert db.get(b"k3") == b"v3" and not os.path.exists(stray)
    db.close()
    seg = os.path.join(path, "seg-00000.kv")
    shutil.copy(seg, seg + ".new")
    os.unlink(seg)
    with open(os.path.join(path, "compact.done"), "w") as f:
        f.write("0\n")
    db = NativeKvDb(path)
    assert db.get(b"k7") == b"v7"
    assert os.path.exists(seg) and not os.path.exists(seg + ".new")
    assert not os.path.exists(os.path.join(path, "compact.done"))
    db.close()


def test_compaction_gate_and_read_cache(tmp_path):
    """Overwrite churn past the dead-bytes gate makes `kv_compact` run
    unforced; a multi-segment store compacted after a sealed segment's
    read was cached reads every value right, before and after reopen."""
    db = NativeKvDb(str(tmp_path / "gate"))
    blob = os.urandom(512 * 1024)
    for _ in range(40):  # ~20 MB written, ~19.5 MB dead
        db.put(b"churn", blob)
    st = db.stats()
    assert st["dead_bytes"] > st["live_bytes"] * 2
    assert native.kv_compact(db._h) is True
    assert db.stats()["dead_bytes"] == 0 and db.get(b"churn") == blob
    db.close()

    path = str(tmp_path / "segments")
    db = NativeKvDb(path, seg_limit=8192)
    values = {}
    for i in range(64):
        k = b"key-%03d" % i
        values[k] = os.urandom(1024)
        db.put(k, values[k])
    for i in range(0, 64, 2):
        db.delete(b"key-%03d" % i)
        del values[b"key-%03d" % i]
    assert db.stats()["active_segment"] > 1
    assert db.get(b"key-001") == values[b"key-001"]  # warm the sealed-segment cache
    db.compact()
    assert all(db.get(k) == v for k, v in values.items())
    db.close()
    db = NativeKvDb(path, seg_limit=8192)
    assert all(db.get(k) == v for k, v in values.items())
    db.close()


def test_closed_handle_raises(tmp_path):
    """A closed store refuses calls (the JAX capsule raises ValueError)."""
    db = NativeKvDb(str(tmp_path / "kv"))
    db.put(b"a", b"b")
    db.close()
    db.close()  # idempotent
    with pytest.raises(ValueError):
        db.get(b"a")
