"""Epoch-scoped pubkey table: decompressed G1 limbs of the active
validator set, kept for the whole epoch (the JAX package's
`parallel/epoch_table.py`).

Committees are fixed per epoch, so the attestation workload reads the
same pubkeys thousands of times between transitions. The beacon node
populates one entry per epoch (`TorchBlsVerifier.epoch_table_populate`,
with the active validator set), and `TorchBlsVerifier._pk_rows` consults
the table before it pays for a C-tier decompression:

- one `_EpochEntry` per epoch: packed (rows, 2·32) int32 limbs (x‖y per
  row, the `_pk_cache` row format) as a host numpy mirror, which serves
  the marshal path with a copy instead of an Fp square root, and as one
  int32 tensor on the device, gathered by `gather_device`;
- LRU over `epochs` entries (2: the current and the next epoch, as the
  reference keeps its EpochContext pair): populating epoch N+1 evicts
  epoch N−1;
- a device copy that runs out of memory (`torch.cuda.OutOfMemoryError`)
  leaves the entry host-only, and the lookups keep working off the
  mirror. Any other error of the copy raises: the port hides no device
  fault.

The JAX package reads its defaults from LODESTAR_TPU_EPOCH_TABLE_EPOCHS
and LODESTAR_TPU_EPOCH_TABLE_MAX_ROWS (2 and 2^21); the port hard-codes
them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..observability.stages import default_pipeline

N_LIMBS = 32
ROW_WIDTH = 2 * N_LIMBS  # packed x‖y limbs, the _pk_cache row format
EPOCHS = 2
MAX_ROWS = 1 << 21


def _gather_kernel(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Device gather of packed pubkey rows: the epoch table's unit of the
    compile ledger (`epoch_table`)."""
    return torch.index_select(table, 0, idx)


class _EpochEntry:
    """One epoch's packed pubkey rows and key → row index."""

    __slots__ = ("epoch", "rows_np", "rows_dev", "index", "device_resident")

    def __init__(self, epoch: int, rows_np: np.ndarray, index: dict):
        self.epoch = int(epoch)
        self.rows_np = rows_np
        self.rows_dev = None
        self.index = index
        self.device_resident = False


class EpochPubkeyTable:
    """Decompressed G1 limbs keyed by epoch, LRU over `epochs` entries of
    at most `max_rows` rows, on `device` (default: the GPU; raises without
    one) with a host mirror for the marshal path. `observer` (default: the
    port's `default_pipeline()`) gets the hit, miss, occupancy and
    eviction events.

    Thread-safe: gossip threads look rows up while the epoch-transition
    thread populates the next entry."""

    def __init__(self, epochs: int = EPOCHS, max_rows: int = MAX_ROWS, observer=None,
                 device=None):
        self.epochs = int(epochs)
        self.max_rows = int(max_rows)
        self.observer = observer if observer is not None else default_pipeline()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._gather = None  # the ledger-wrapped gather, made at first use
        self._gather_lock = threading.Lock()
        self._entries: OrderedDict[int, _EpochEntry] = OrderedDict()  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock
        self._device_failures = 0  # guarded-by: _lock

    # -- population (epoch transition) ----------------------------------------

    def populate(self, epoch: int, items) -> int:
        """Install one epoch's entry from `items`, (pubkey_bytes, packed_row)
        pairs with packed_row a (2·32,) int32 array; returns the rows
        installed.

        Re-populating an epoch replaces it; rows beyond `max_rows` are
        dropped and counted as evictions."""
        index: dict[bytes, int] = {}
        rows: list[np.ndarray] = []
        truncated = 0
        for key, row in items:
            if len(index) >= self.max_rows:
                truncated += 1
                continue
            if key in index:
                continue
            index[key] = len(rows)
            rows.append(row)
        rows_np = (np.stack(rows).astype(np.int32) if rows
                   else np.zeros((0, ROW_WIDTH), np.int32))
        entry = _EpochEntry(epoch, rows_np, index)
        entry.device_resident = self._try_device_copy(entry)
        with self._lock:
            self._entries.pop(int(epoch), None)
            self._entries[int(epoch)] = entry
            if truncated:
                self._evictions += truncated
                self.observer.epoch_table_eviction(truncated)
            while len(self._entries) > max(1, self.epochs):
                _, old = self._entries.popitem(last=False)
                self._evictions += old.rows_np.shape[0]
                self.observer.epoch_table_eviction(old.rows_np.shape[0])
            self.observer.epoch_table_occupancy(
                sum(e.rows_np.shape[0] for e in self._entries.values()))
        return rows_np.shape[0]

    def _try_device_copy(self, entry: _EpochEntry) -> bool:
        """Copy the rows to the device; out of device memory, the entry
        stays host-only and a device failure is counted."""
        if entry.rows_np.shape[0] == 0:
            return False
        try:
            entry.rows_dev = torch.as_tensor(entry.rows_np).to(self.device)
        except torch.cuda.OutOfMemoryError:
            with self._lock:
                self._device_failures += 1
            entry.rows_dev = None
            return False
        return True

    # -- lookup (hot path) -----------------------------------------------------

    def lookup_rows(self, keys) -> list:
        """Packed (2·32,) rows (host mirror) for each pubkey-bytes key, None
        per miss, the newest epoch first; one hit and one miss event per
        batch, not per key."""
        hits: list = [None] * len(keys)
        n_hit = 0
        with self._lock:
            entries = list(self._entries.values())
        for i, k in enumerate(keys):
            for e in reversed(entries):
                row = e.index.get(k)
                if row is not None:
                    hits[i] = e.rows_np[row]
                    n_hit += 1
                    break
        self.observer.epoch_table_event(True, n=n_hit)
        self.observer.epoch_table_event(False, n=len(keys) - n_hit)
        return hits

    def gather_device(self, epoch: int, idx) -> torch.Tensor | None:
        """Rows `idx` of one epoch's device tensor (`torch.index_select`
        through the compile ledger's wrap seam, kernel `epoch_table`); None
        when the entry is absent or host-only (callers use the host
        mirror)."""
        with self._lock:
            entry = self._entries.get(int(epoch))
        if entry is None or not entry.device_resident:
            return None
        if self._gather is None:
            with self._gather_lock:
                if self._gather is None:
                    from ..observability.compile_ledger import ledger

                    self._gather = ledger().wrap(_gather_kernel, "epoch_table")
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        return self._gather(entry.rows_dev, idx)

    def device_bytes(self) -> int:
        """Bytes of the device-resident rows."""
        with self._lock:
            return sum(e.rows_dev.numel() * e.rows_dev.element_size()
                       for e in self._entries.values() if e.rows_dev is not None)

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The table's state, as `/debug/epoch_table` shows it."""
        with self._lock:
            entries = [
                {"epoch": e.epoch, "rows": int(e.rows_np.shape[0]),
                 "device_resident": bool(e.device_resident)}
                for e in self._entries.values()
            ]
            return {
                "epochs_retained": self.epochs,
                "max_rows": self.max_rows,
                "entries": entries,
                "total_rows": sum(en["rows"] for en in entries),
                "evictions": self._evictions,
                "device_put_failures": self._device_failures,
            }
