"""Device-backed feature-vector store with a dynamic ID universe.

Counterpart of ``oryx_tpu/app/als/feature_vectors.py`` (reference:
FeatureVectors.java:28-86, PartitionedFeatureVectors.java:43-222).

IDs live in a host dict mapping to rows of a padded device tensor.
Single-row "UP" mutations write a host mirror and enqueue the row; the
device copy is refreshed lazily at the next read — a scatter of the
dirty rows into a fresh snapshot for few of them, a full re-upload when
many changed — so a reader always holds a consistent snapshot.  Removed
rows are zeroed and recycled via a free list; capacity grows by
doubling.

With a ``mesh`` (``parallel/mesh.Mesh``) the device snapshot is one row
block per mesh entry, each on its entry's device (reference
``feature_vectors.py:81-114``: a ``device_sharding`` that row-shards the
snapshot): the capacity is a multiple of the mesh size, so the blocks
are equal, and the rows past the live ones are inactive.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ...common.device import device_context, resolve_device
from ...common.lang import AutoReadWriteLock

__all__ = ["FeatureVectorStore", "planned_capacity", "resolve_dtype",
           "device_width"]

# above this fraction of dirty rows, re-upload the whole array instead of
# scattering individual rows
_FULL_UPLOAD_FRACTION = 0.5

# beyond this many rows, capacity is rounded to a multiple of this chunk
# instead of the next power of two: a 20M-item model must not allocate a
# 32M-row device array, and the streaming top-N requires the row count
# to be a multiple of its scan chunk
_LARGE_ALIGN = 1 << 17

# device snapshots pad the feature columns to a multiple of this: rows
# stay 16-byte aligned for the phase-A kernel's vector loads (a 250 x
# 4-byte row is not), and the kernel stages 32 columns at a time.  The
# zero columns are exact in every dot product.
_WIDTH_ALIGN = 32


def device_width(features: int) -> int:
    """Column count of the device snapshot for ``features`` features."""
    return -(-features // _WIDTH_ALIGN) * _WIDTH_ALIGN


def _gramian(vecs: torch.Tensor) -> torch.Tensor:
    v = vecs.to(torch.float32)
    if v.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("vtv needs full float32 products; "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    return v.T @ v


def planned_capacity(n_rows: int, initial_capacity: int = 1024) -> int:
    """The padded row capacity a fresh store ends up with after a
    single ``bulk_load`` of ``n_rows`` vectors — the leading dimension
    every serving kernel sees for a model of that size.  Kept in
    lock-step with ``__init__``/``_grow``."""
    cap = max(16, initial_capacity)
    if n_rows > cap:
        # one _grow(min_capacity=n_rows) from the fresh store
        cap = max(cap * 2, n_rows)
    if cap > _LARGE_ALIGN:
        cap = -(-cap // _LARGE_ALIGN) * _LARGE_ALIGN
    return cap


def resolve_dtype(name) -> torch.dtype:
    """Device storage dtype from a config string.  ``bfloat16`` halves
    the device footprint (a 21M x 250 model then fits one card), and
    the phase-A kernel multiplies bf16 by bf16 with float32
    accumulation.

    Unlike the reference's ``resolve_dtype`` (``feature_vectors.py:60``),
    which returns an ``ml_dtypes.bfloat16`` NumPy dtype for the host
    mirror too, the host mirror here stays float32 holding values
    rounded through ``torch.bfloat16``: both round to nearest even, so
    the values are the same, and NumPy has no bfloat16 of its own."""
    if name is None or name is torch.float32:
        return torch.float32
    if name is torch.bfloat16:
        return torch.bfloat16
    name = str(name)
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32"):
        return torch.float32
    raise ValueError(f"unsupported factor dtype: {name}")


class FeatureVectorStore:
    """Mutable {id -> float32[k]} map materialized as a device tensor."""

    def __init__(self, features: int, initial_capacity: int = 1024,
                 dtype="float32", device=None, mesh=None):
        self.features = features
        self.device = resolve_device(device)
        self.device_features = device_width(features)
        self.dtype = resolve_dtype(dtype)
        self.mesh = mesh
        self._cap_multiple = 1
        if mesh is not None:
            n_dev = mesh.size
            if n_dev & (n_dev - 1):
                raise ValueError(
                    f"sharded store needs a power-of-two device count, "
                    f"got {n_dev}")
            self._cap_multiple = n_dev
        cap = max(16, initial_capacity, self._cap_multiple)
        if cap > _LARGE_ALIGN:
            cap = -(-cap // _LARGE_ALIGN) * _LARGE_ALIGN
        cap = -(-cap // self._cap_multiple) * self._cap_multiple
        self._id_to_row: dict[str, int] = {}
        self._row_to_id: list[str | None] = [None] * cap
        self._free: list[int] = list(range(cap - 1, -1, -1))
        self._host = np.zeros((cap, features), dtype=np.float32)
        self._active = np.zeros(cap, dtype=bool)
        self._dirty: set[int] = set()
        self._device: torch.Tensor | None = None
        self._device_active: torch.Tensor | None = None
        self._device_version = 0
        self._recent: set[str] = set()
        self._lock = AutoReadWriteLock()
        # row->id snapshot cache for the serving hot path; invalidated
        # by bumping _mutations under the write lock
        self._mutations = 0
        self._row_ids_cache: list[str | None] | None = None
        self._row_ids_mutations = -1

    def _round(self, matrix: np.ndarray) -> np.ndarray:
        """Host values as the device stores them: float32, rounded
        through bfloat16 for a bf16 store."""
        matrix = np.asarray(matrix, dtype=np.float32)
        if self.dtype == torch.bfloat16:
            matrix = torch.from_numpy(matrix).to(torch.bfloat16).to(
                torch.float32).numpy()
        return matrix

    # -- basic map ops ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock.read():
            return len(self._id_to_row)

    def all_ids(self) -> list[str]:
        with self._lock.read():
            return list(self._id_to_row.keys())

    def __contains__(self, id_: str) -> bool:
        with self._lock.read():
            return id_ in self._id_to_row

    def get_vector(self, id_: str) -> np.ndarray | None:
        with self._lock.read():
            row = self._id_to_row.get(id_)
            return None if row is None else self._host[row].copy()

    def row_of(self, id_: str) -> int | None:
        with self._lock.read():
            return self._id_to_row.get(id_)

    def id_of(self, row: int) -> str | None:
        with self._lock.read():
            return self._row_to_id[row] \
                if 0 <= row < len(self._row_to_id) else None

    def set_vector(self, id_: str, vector: np.ndarray) -> None:
        vector = self._round(np.asarray(vector)[None, :])[0]
        with self._lock.write():
            row = self._id_to_row.get(id_)
            if row is None:
                if not self._free:
                    self._grow()
                row = self._free.pop()
                self._id_to_row[id_] = row
                self._row_to_id[row] = id_
                self._mutations += 1
            self._host[row] = vector
            self._active[row] = True
            self._dirty.add(row)
            self._recent.add(id_)

    def bulk_load(self, ids: list[str], matrix: np.ndarray) -> None:
        """Set many vectors at once: equivalent to set_vector per row but
        one vectorized host write instead of n dict/array operations."""
        matrix = self._round(matrix)
        if matrix.shape != (len(ids), self.features):
            raise ValueError(
                f"matrix must be ({len(ids)}, {self.features}), "
                f"got {matrix.shape}")
        with self._lock.write():
            new_ids = [i for i in ids if i not in self._id_to_row]
            if len(self._free) < len(new_ids):
                # size once, exactly: a 20M-row load must not hit
                # pow2-doubling
                self._grow(len(self._id_to_row) + len(new_ids))
            rows = np.empty(len(ids), dtype=np.int64)
            for j, id_ in enumerate(ids):
                row = self._id_to_row.get(id_)
                if row is None:
                    row = self._free.pop()
                    self._id_to_row[id_] = row
                    self._row_to_id[row] = id_
                    self._mutations += 1
                rows[j] = row
            self._host[rows] = matrix
            self._active[rows] = True
            self._dirty.update(rows.tolist())
            self._recent.update(ids)

    def load_rows(self, row_ids: list[str | None],
                  matrix: np.ndarray) -> None:
        """Fill an empty store row for row: ``row_ids[r]`` names the id
        at row ``r`` of ``matrix``, None a free row — the form
        ``host_arrays`` returns.  Row positions carry over exactly, and
        with them the lowest-row-first order of tied scores."""
        matrix = self._round(matrix)
        if matrix.shape != (len(row_ids), self.features):
            raise ValueError(
                f"matrix must be ({len(row_ids)}, {self.features}), "
                f"got {matrix.shape}")
        with self._lock.write():
            if self._id_to_row:
                raise ValueError("load_rows needs an empty store")
            n = len(row_ids)
            if len(self._row_to_id) < n:
                self._grow(n)
            self._id_to_row = {id_: row for row, id_ in enumerate(row_ids)
                               if id_ is not None}
            self._row_to_id[:n] = row_ids
            used = np.fromiter((i is not None for i in row_ids), bool, n)
            # written in place: a where() against a Python float would
            # round-trip the whole matrix through float64
            self._host[:n] = matrix
            if not used.all():
                self._host[:n][~used] = 0.0
            self._active[:n] = used
            self._free = [r for r in range(len(self._row_to_id) - 1, -1, -1)
                          if self._row_to_id[r] is None]
            self._mutations += 1
            self._dirty.update(range(len(row_ids)))
            self._recent.update(self._id_to_row)

    def remove(self, id_: str) -> None:
        with self._lock.write():
            row = self._id_to_row.pop(id_, None)
            if row is not None:
                self._row_to_id[row] = None
                self._mutations += 1
                self._host[row] = 0.0
                self._active[row] = False
                self._dirty.add(row)
                self._free.append(row)

    def recent_ids(self) -> set[str]:
        """IDs set since the last retain (reference:
        FeatureVectors.addAllRecentTo)."""
        with self._lock.read():
            return set(self._recent)

    def retain_recent_and_ids(self, ids: Iterable[str]) -> None:
        """Drop all IDs not in ``ids`` and not recently set; clear the
        recent set (reference: FeatureVectors.retainRecentAndIDs — the
        MODEL-swap grace logic)."""
        keep = set(ids)
        with self._lock.write():
            keep |= self._recent
            for id_ in [i for i in self._id_to_row if i not in keep]:
                row = self._id_to_row.pop(id_)
                self._row_to_id[row] = None
                self._mutations += 1
                self._host[row] = 0.0
                self._active[row] = False
                self._dirty.add(row)
                self._free.append(row)
            self._recent.clear()

    def reserve(self, n_rows: int) -> None:
        """Pre-size the store for ``n_rows`` expected vectors with ONE
        exact-fit grow — the capacity ``planned_capacity`` predicts."""
        with self._lock.write():
            if len(self._row_to_id) < n_rows:
                self._grow(n_rows)

    def _grow(self, min_capacity: int | None = None) -> None:
        old_cap = len(self._row_to_id)
        if old_cap >= 4 * _LARGE_ALIGN:
            # large stores grow by ~12.5% in chunk steps: doubling a
            # 20M-row exact-fit array would allocate the very padding
            # bulk_load avoids
            new_cap = old_cap + max(_LARGE_ALIGN, old_cap // 8)
        else:
            new_cap = old_cap * 2
        if min_capacity is not None and min_capacity > new_cap:
            new_cap = min_capacity
        if new_cap > _LARGE_ALIGN:
            new_cap = -(-new_cap // _LARGE_ALIGN) * _LARGE_ALIGN
        new_cap = -(-new_cap // self._cap_multiple) * self._cap_multiple
        host = np.zeros((new_cap, self.features), dtype=np.float32)
        host[:old_cap] = self._host
        self._host = host
        active = np.zeros(new_cap, dtype=bool)
        active[:old_cap] = self._active
        self._active = active
        self._row_to_id.extend([None] * (new_cap - old_cap))
        self._mutations += 1
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))
        self._device = None  # force full re-upload at next sync
        self._device_active = None

    # -- device snapshot ----------------------------------------------------

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(vectors, active_mask) on the device, syncing pending host
        writes."""
        vecs, active, _ = self.device_arrays_versioned()
        return vecs, active

    def device_arrays_versioned(
            self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Like device_arrays but also returns the snapshot's version,
        read atomically under the same lock — the safe cache key for
        derived device state (LSH buckets, the phase-A penalty).

        A snapshot is never written in place: the dirty-row scatter
        lands in a copy, so a reader that holds the previous snapshot
        (a drain between its phase A and its phase B) keeps seeing one
        consistent matrix, as the reference's immutable arrays give.

        A sharded store's snapshot is per entry: ``shard_arrays_versioned``."""
        if self.mesh is not None:
            raise TypeError("a sharded store's snapshot is one block per "
                            "mesh entry: use shard_arrays_versioned")
        with self._lock.write():
            cap = len(self._row_to_id)
            if self._device is None \
                    or len(self._dirty) >= cap * _FULL_UPLOAD_FRACTION:
                self._device = self._upload(self._host)
                self._device_active = torch.from_numpy(
                    self._active.copy()).to(self.device)
                self._device_version += 1
            elif self._dirty:
                rows = np.fromiter(self._dirty, dtype=np.int64,
                                   count=len(self._dirty))
                idx = torch.from_numpy(rows).to(self.device)
                vecs = self._device.clone()
                vecs[idx] = self._upload(self._host[rows])
                active = self._device_active.clone()
                active[idx] = torch.from_numpy(self._active[rows]).to(
                    self.device)
                self._device, self._device_active = vecs, active
                self._device_version += 1
            self._dirty.clear()
            return self._device, self._device_active, self._device_version

    def shard_arrays_versioned(
            self) -> tuple[list[torch.Tensor], list[torch.Tensor], int]:
        """A sharded store's snapshot: (one row block per local mesh
        entry, each entry's active mask, version), synced as
        ``device_arrays_versioned`` syncs, a changed block copied before
        its rows are written."""
        mesh = self.mesh
        with self._lock.write():
            cap = len(self._row_to_id)
            rows_per = cap // mesh.size
            lo = [(mesh.first_entry + e) * rows_per
                  for e in range(mesh.local_size)]
            if self._device is None \
                    or len(self._dirty) >= cap * _FULL_UPLOAD_FRACTION:
                host = self._padded(self._host)
                active = torch.from_numpy(self._active.copy())
                self._device = [host[a:a + rows_per].to(d)
                                for a, d in zip(lo, mesh.devices)]
                self._device_active = [active[a:a + rows_per].to(d)
                                       for a, d in zip(lo, mesh.devices)]
                self._device_version += 1
            elif self._dirty:
                rows = np.sort(np.fromiter(self._dirty, dtype=np.int64,
                                           count=len(self._dirty)))
                vecs, act = list(self._device), list(self._device_active)
                for e, (a, d) in enumerate(zip(lo, mesh.devices)):
                    mine = rows[(rows >= a) & (rows < a + rows_per)]
                    if not len(mine):
                        continue
                    with device_context(d):
                        idx = torch.from_numpy(mine - a).to(d)
                        vecs[e] = vecs[e].clone()
                        vecs[e][idx] = self._padded(self._host[mine]).to(d)
                        act[e] = act[e].clone()
                        act[e][idx] = torch.from_numpy(
                            self._active[mine]).to(d)
                self._device, self._device_active = vecs, act
                self._device_version += 1
            self._dirty.clear()
            return self._device, self._device_active, self._device_version

    def _padded(self, host: np.ndarray) -> torch.Tensor:
        """Host rows as device rows, on the host: columns zero-padded to
        the device width, cast to the store dtype."""
        out = torch.zeros((host.shape[0], self.device_features),
                          dtype=self.dtype)
        out[:, :self.features] = torch.from_numpy(host)
        return out

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """Host rows as device rows: columns zero-padded to the device
        width and cast to the store dtype on the host, so a bf16 store
        moves half the bytes."""
        return self._padded(host).to(self.device)

    def row_ids(self) -> list[str | None]:
        """Snapshot of the row -> id table for batched result decoding,
        cached against the mutation counter."""
        with self._lock.read():
            if self._row_ids_cache is None \
                    or self._row_ids_mutations != self._mutations:
                self._row_ids_cache = list(self._row_to_id)
                self._row_ids_mutations = self._mutations
            return self._row_ids_cache

    def vtv(self) -> np.ndarray:
        """V^T V over the live vectors, one float32 matmul on the device
        (retired rows are zero; the padding columns are sliced off).
        Reference: FeatureVectors.getVTV.  A sharded store sums the
        entries' partial products (``mesh.psum``)."""
        if self.mesh is None:
            vecs, _ = self.device_arrays()
            out = _gramian(vecs).cpu().numpy()
        else:
            from ...parallel.mesh import psum
            blocks, _, _ = self.shard_arrays_versioned()
            parts = []
            for d, b in zip(self.mesh.devices, blocks):
                with device_context(d):
                    parts.append(_gramian(b))
            out = psum(self.mesh, parts)[0].cpu().numpy()
        return out[:self.features, :self.features]

    def host_arrays(self) -> tuple[np.ndarray, np.ndarray, list[str | None]]:
        """Copy of (vectors, active, row->id) for host-side iteration."""
        with self._lock.read():
            return (self._host.copy(), self._active.copy(),
                    list(self._row_to_id))
