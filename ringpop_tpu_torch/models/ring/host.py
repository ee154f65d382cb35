"""Host-side consistent hash ring.

Same semantics as the reference's HashRing (ringpop-node lib/ring/index.js):
100 replica points per server hashed as ``hash32(server + str(i))``
(index.js:50-58), ``lookup`` = first ring point whose hash is >= the key's
hash with wraparound to the minimum (index.js:145-154 — note the rbtree's
``upperBound`` is, despite its name, a lower bound: rbtree.js:235-271, which
ring-test.js's '1000 lookups' depends on), ``lookupN`` walks unique
successors with a full-cycle corruption guard (index.js:157-189), and the
ring checksum is ``hash32`` of the sorted server names joined with ';'
(index.js:96-105).

Array re-design: the reference's red-black tree exists solely to provide
ordered search plus in-order iteration; here the ring is a sorted numpy table
of (point hash, owner) and lookups are ``np.searchsorted`` — the same layout
the device ring (models/ring/device.py) uses, so host and device agree
structurally and numerically.  Where rbtree iteration order among *colliding*
replica points depends on insertion order, this ring orders collisions by
(hash, server name) — deterministic, history-independent, and identical to
the device ring's (hash, universe-index) order because the device universe is
address-sorted.  Each public mutation rebuilds the table with one
O(P log P) lexsort (P = servers x replica points); bulk add/remove pays a
single rebuild, mirroring the reference's one-checksum-per-bulk-change.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ringpop_tpu_torch.ops import native
from ringpop_tpu_torch.utils.config import EventEmitter


class HashRing(EventEmitter):
    def __init__(self, replica_points: int = 100, hash_func=None):
        super().__init__()
        self.replica_points = replica_points
        self.hash_func = hash_func or native.hash32
        self._use_native_replicas = hash_func is None

        self.servers: Dict[str, bool] = {}
        self.checksum: Optional[int] = None
        # per-server replica hashes, keyed by name (uint32 [R])
        self._server_points: Dict[str, np.ndarray] = {}
        # sorted ring table (by hash, ties by server name); owners stored as
        # ranks into the sorted name list, rebuilt LAZILY on first lookup —
        # a burst of N individual add/remove calls (the reference pays an
        # rbtree insert each; we'd pay N full sorts) costs one sort total
        self._hashes = np.empty(0, dtype=np.uint64)
        self._owner_ranks = np.empty(0, dtype=np.int64)
        self._names: List[str] = []
        self._table_dirty = False

    # -- construction -----------------------------------------------------

    def _replica_hashes(self, server: str) -> np.ndarray:
        if self._use_native_replicas:
            return native.replica_hashes(server, self.replica_points)
        return np.array(
            [self.hash_func(server + str(i)) for i in range(self.replica_points)],
            dtype=np.uint64,
        )

    def _rebuild(self) -> None:
        self._table_dirty = False
        if not self._server_points:
            self._hashes = np.empty(0, dtype=np.uint64)
            self._owner_ranks = np.empty(0, dtype=np.int64)
            self._names = []
            return
        names = sorted(self._server_points.keys())
        hashes = np.concatenate([self._server_points[n] for n in names]).astype(
            np.uint64
        )
        owner_rank = np.repeat(np.arange(len(names)), self.replica_points)
        order = np.lexsort((owner_rank, hashes))
        self._hashes = hashes[order]
        self._owner_ranks = owner_rank[order]
        self._names = names

    def _ensure_table(self) -> None:
        if self._table_dirty:
            self._rebuild()

    def add_server(self, name: str) -> None:
        if self.has_server(name):
            return
        self.servers[name] = True
        self._server_points[name] = self._replica_hashes(name)
        self._table_dirty = True
        self.compute_checksum()
        self.emit("added", name)

    def remove_server(self, name: str) -> None:
        if not self.has_server(name):
            return
        del self.servers[name]
        del self._server_points[name]
        self._table_dirty = True
        self.compute_checksum()
        self.emit("removed", name)

    def add_remove_servers(
        self,
        servers_to_add: Optional[Sequence[str]] = None,
        servers_to_remove: Optional[Sequence[str]] = None,
    ) -> bool:
        servers_to_add = servers_to_add or []
        servers_to_remove = servers_to_remove or []
        added = False
        removed = False
        for s in servers_to_add:
            if not self.has_server(s):
                self.servers[s] = True
                self._server_points[s] = self._replica_hashes(s)
                added = True
        for s in servers_to_remove:
            if self.has_server(s):
                del self.servers[s]
                del self._server_points[s]
                removed = True
        changed = added or removed
        if changed:
            self._table_dirty = True
            self.compute_checksum()
        return changed

    # -- checksum ---------------------------------------------------------

    def compute_checksum(self) -> int:
        server_name_str = ";".join(sorted(self.servers.keys()))
        self.checksum = self.hash_func(server_name_str)
        # blob payload for the ring.checksum.computed trace tap
        self.emit(
            "checksumComputed",
            {"checksum": self.checksum, "serverCount": len(self.servers)},
        )
        return self.checksum

    # -- queries ----------------------------------------------------------

    def has_server(self, name: str) -> bool:
        return name in self.servers

    def get_server_count(self) -> int:
        return len(self.servers)

    def get_stats(self) -> dict:
        return {"checksum": self.checksum, "servers": list(self.servers.keys())}

    def _lower_bound(self, h: int) -> int:
        """Index of the first ring point with hash >= h (== size if none)."""
        return int(np.searchsorted(self._hashes, h, side="left"))

    def lookup(self, key) -> Optional[str]:
        self._ensure_table()
        if self._hashes.size == 0:
            return None
        h = self.hash_func(str(key))
        idx = self._lower_bound(h)
        if idx == self._hashes.size:
            idx = 0  # wraparound to min()
        return self._names[self._owner_ranks[idx]]

    def lookup_n(self, key, n: int) -> List[str]:
        """Up to ``n`` unique successor servers — ring/index.js:157-189."""
        self._ensure_table()
        server_count = self.get_server_count()
        n = min(n, server_count)
        if n <= 0 or self._hashes.size == 0:
            return []
        h = self.hash_func(str(key))
        start = self._lower_bound(h)
        result: List[str] = []
        seen = set()
        size = self._hashes.size
        # full-cycle guard mirrors the reference's firstVal check
        for step in range(size):
            name = self._names[self._owner_ranks[(start + step) % size]]
            if name not in seen:
                seen.add(name)
                result.append(name)
                if len(result) >= n:
                    break
        return result

    # -- device handoff ---------------------------------------------------

    def table(self):
        """The sorted (hash, owner-name) table — the layout the device ring
        consumes (models/ring/device.py)."""
        self._ensure_table()
        return (
            self._hashes.astype(np.uint32),
            [self._names[r] for r in self._owner_ranks],
        )
