"""The port's epoch pubkey table (`parallel/epoch_table.py`) and the
verifier's use of it, on the CPU (no kernel runs here: the table and the
marshal path are host work, and the device rows are a CPU tensor).

The cases of the JAX package's tests/test_epoch_table.py: the LRU over two
epochs, re-population, the row cap, the metrics (the JAX
`PipelineMetrics` injected), concurrent population and lookup, malformed
keys skipped, pubkeys served from the table without a decompression, the
decompression on a miss. Also: the rows equal the JAX table's for the same
keys; a device copy that runs out of memory (`torch.cuda.OutOfMemoryError`,
patched in) leaves the entry host-only and the marshal path served, while
any other error of the copy raises.
"""

import threading

import numpy as np
import pytest
import torch

from lodestar_tpu.bls import api as bls
from lodestar_tpu.observability.stages import PipelineMetrics
from lodestar_tpu.parallel.epoch_table import EpochPubkeyTable as JaxEpochPubkeyTable
from lodestar_tpu.parallel.verifier import TpuBlsVerifier
from lodestar_tpu_torch import native
from lodestar_tpu_torch.parallel.epoch_table import ROW_WIDTH, EpochPubkeyTable
from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

torch.set_num_threads(1)


def _rows(n, start=0):
    return [(bytes([start + i]) * 48, np.full(ROW_WIDTH, start + i, np.int32))
            for i in range(n)]


def _table(**kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("max_rows", 64)
    kw.setdefault("observer", PipelineMetrics())
    kw.setdefault("device", "cpu")
    return EpochPubkeyTable(**kw)


def _sets(n, salt=0):
    out = []
    for i in range(n):
        sk = bls.interop_secret_key(i + salt)
        msg = b"\x42" * 32
        out.append(bls.SignatureSet(pubkey=sk.to_public_key(), message=msg,
                                    signature=sk.sign(msg).to_bytes()))
    return out


def _raise_on_copy(monkeypatch, exc):
    def copy(self, *a, **kw):
        raise exc

    monkeypatch.setattr(torch.Tensor, "to", copy)


# --- table bookkeeping -------------------------------------------------------


def test_lru_rotation_over_two_epochs():
    t = _table(epochs=2)
    assert t.populate(0, _rows(4)) == 4
    assert t.populate(1, _rows(2, start=10)) == 2
    assert [e["epoch"] for e in t.snapshot()["entries"]] == [0, 1]
    t.populate(2, _rows(3, start=20))
    snap = t.snapshot()
    assert [e["epoch"] for e in snap["entries"]] == [1, 2]
    assert snap["evictions"] == 4  # epoch 0's rows
    assert t.lookup_rows([bytes([0]) * 48]) == [None]
    hit = t.lookup_rows([bytes([10]) * 48])[0]
    assert hit is not None and hit[0] == 10


def test_repopulating_same_epoch_replaces_not_rotates():
    t = _table(epochs=2)
    t.populate(0, _rows(4))
    t.populate(1, _rows(4, start=10))
    t.populate(1, _rows(2, start=50))
    snap = t.snapshot()
    assert [e["epoch"] for e in snap["entries"]] == [0, 1]
    assert t.lookup_rows([bytes([10]) * 48]) == [None]
    assert t.lookup_rows([bytes([50]) * 48])[0] is not None


def test_newest_epoch_wins_a_key_in_both():
    t = _table()
    t.populate(0, [(b"\x07" * 48, np.full(ROW_WIDTH, 1, np.int32))])
    t.populate(1, [(b"\x07" * 48, np.full(ROW_WIDTH, 2, np.int32))])
    assert t.lookup_rows([b"\x07" * 48])[0][0] == 2


def test_row_cap_truncation_counts_as_evictions():
    t = _table(max_rows=3)
    assert t.populate(0, _rows(5)) == 3
    snap = t.snapshot()
    assert snap["total_rows"] == 3
    assert snap["evictions"] == 2


def test_occupancy_and_hit_miss_metrics():
    pm = PipelineMetrics()
    t = _table(observer=pm)
    t.populate(0, _rows(3))
    t.lookup_rows([bytes([0]) * 48, bytes([1]) * 48, bytes([99]) * 48])
    assert [int(v) for _, v in pm.epoch_table_hits.collect()] == [2]
    assert [int(v) for _, v in pm.epoch_table_misses.collect()] == [1]
    assert [int(v) for _, v in pm.epoch_table_occupancy_gauge.collect()] == [3]
    t.populate(1, _rows(2, start=10))
    t.populate(2, _rows(2, start=20))  # rotates epoch 0 out
    assert [int(v) for _, v in pm.epoch_table_evictions.collect()] == [3]


def test_rows_live_on_the_device_and_gather():
    t = _table()
    t.populate(0, _rows(4))
    snap = t.snapshot()
    # the table's own snapshot has the JAX table's keys: "enabled" is the
    # verifier's to add (test_table_rows_equal_the_jax_tables)
    assert "enabled" not in snap and snap["device_put_failures"] == 0
    assert set(snap) == set(JaxEpochPubkeyTable().snapshot())
    assert snap["entries"][0]["device_resident"] is True
    assert t.device_bytes() == 4 * ROW_WIDTH * 4
    out = t.gather_device(0, [3, 1])
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.stack([_rows(4)[3][1], _rows(4)[1][1]]))
    assert t.gather_device(5, [0]) is None  # no such epoch


def test_device_out_of_memory_degrades_to_host_only(monkeypatch):
    t = _table()
    _raise_on_copy(monkeypatch, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert t.populate(0, _rows(4)) == 4  # population does not raise
    snap = t.snapshot()
    assert snap["device_put_failures"] == 1
    assert snap["entries"][0]["device_resident"] is False
    assert t.lookup_rows([bytes([2]) * 48])[0] is not None
    assert t.gather_device(0, [0]) is None
    assert t.device_bytes() == 0


def test_any_other_copy_error_raises(monkeypatch):
    t = _table()
    _raise_on_copy(monkeypatch, RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        t.populate(0, _rows(4))
    assert t.snapshot()["device_put_failures"] == 0


def test_concurrent_populate_and_lookup():
    t = _table(epochs=2)
    stop = threading.Event()
    errors = []

    def reader():
        keys = [bytes([i]) * 48 for i in range(8)]
        while not stop.is_set():
            try:
                t.lookup_rows(keys)
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=reader, daemon=True) for _ in range(4)]
    for th in threads:
        th.start()
    for epoch in range(12):
        t.populate(epoch, _rows(8, start=epoch % 4))
    stop.set()
    for th in threads:
        th.join(timeout=5.0)
    assert not errors
    assert len(t.snapshot()["entries"]) == 2


# --- the verifier's use of the table -------------------------------------------


def test_table_rows_equal_the_jax_tables():
    keys = [s.pubkey.to_bytes() for s in _sets(5, salt=30)]
    ours = TorchBlsVerifier(device="cpu")
    theirs = TpuBlsVerifier(buckets=(4,), mesh=None)
    assert ours.epoch_table_populate(3, keys) == theirs.epoch_table_populate(3, keys) == 5
    a = ours._epoch_table.lookup_rows(keys)
    b = theirs._epoch_table.lookup_rows(keys)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    snap_ours, snap_theirs = ours.epoch_table_snapshot(), theirs.epoch_table_snapshot()
    for k in ("epochs_retained", "max_rows", "entries", "total_rows", "evictions",
              "device_put_failures", "enabled"):
        assert snap_ours[k] == snap_theirs[k], k


def test_pk_rows_served_from_table_without_decompress(monkeypatch):
    v = TorchBlsVerifier(device="cpu")
    assert v._epoch_table is not None  # on by default
    sets = _sets(3)
    ref = v._pk_rows(sets)  # the decompression path fills _pk_cache
    assert ref is not None
    assert v.epoch_table_populate(7, [s.pubkey.to_bytes() for s in sets]) == 3
    v._pk_cache.clear()

    def _no_decompress(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("a table hit skips the C-tier decompression")

    monkeypatch.setattr(native, "g1_decompress", _no_decompress)
    out = v._pk_rows(sets)
    assert out is not None
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])


def test_pk_rows_falls_back_to_decompress_on_table_miss():
    v = TorchBlsVerifier(device="cpu")
    v.epoch_table_populate(7, [s.pubkey.to_bytes() for s in _sets(2, salt=90)])
    out = v._pk_rows(_sets(3))  # none of these in the table
    assert out is not None and out[0].shape == (3, 32)


def test_device_oom_populate_still_serves_marshal_path(monkeypatch):
    """Out of device memory, the host mirror serves `_pk_rows`; with the
    table gone entirely `_pk_cache` still covers the keys."""
    v = TorchBlsVerifier(device="cpu")
    sets = _sets(3, salt=40)
    _raise_on_copy(monkeypatch, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert v.epoch_table_populate(3, [s.pubkey.to_bytes() for s in sets]) == 3
    monkeypatch.undo()
    assert v.epoch_table_snapshot()["device_put_failures"] == 1
    v._pk_cache.clear()
    out = v._pk_rows(sets)  # host mirror
    assert out is not None
    v._epoch_table = None  # the table lost entirely
    assert v.epoch_table_snapshot() == {"enabled": False}
    assert v.epoch_table_populate(4, [sets[0].pubkey.to_bytes()]) == 0
    out2 = v._pk_rows(sets)  # _pk_cache, filled by the table hit above
    assert out2 is not None
    np.testing.assert_array_equal(out[0], out2[0])


def test_populate_skips_malformed_keys():
    v = TorchBlsVerifier(device="cpu")
    good = [s.pubkey.to_bytes() for s in _sets(2)]
    assert v.epoch_table_populate(1, good + [b"\xff" * 48]) == 2
