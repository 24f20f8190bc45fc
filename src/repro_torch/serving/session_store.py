"""Bulk open-addressing session-movement store — loop-free observability.

``SessionRouter`` tracks which sessions changed replica (the
``moved_sessions`` metric: every move is a lost KV/prefix-cache) in a
key -> last-replica map.  The original implementation walked a Python dict
one key at a time, which at batched-ingest rates costs more than the entire
device routing dispatch.  ``SessionStore`` replaces it with a fixed-layout
open-addressing hash table held in two numpy arrays and driven entirely by
vectorised probe/insert rounds (DESIGN.md §9):

* **layout** — ``_keys`` (uint64) and ``_vals`` (int32) of power-of-two
  length; ``_vals == EMPTY`` (-1, never a valid replica id) marks a free
  slot, so key content in free slots is irrelevant and no tombstones exist
  (the store never deletes).
* **probe sequence** — linear: slot_j = (h + j) mod slots, where
  ``h = (key ^ key >> 32) mod slots``.  Session keys are splitmix64 / FNV-1a
  outputs, i.e. already avalanched, so the fold is enough mixing.
* **bulk find** — one numpy round per probe distance over the still-active
  subset: gather slots, resolve rows that hit their key (present) or an
  empty slot (absent — valid because there are no deletions).
* **bulk insert** — per round, every pending row scatters its key at its
  probe slot if free; last-write-wins collisions are resolved by re-reading
  the slot (the winner sees its own key, losers advance to the next probe
  distance).  Load factor is kept <= 1/2 by doubling + rehash, so both
  loops terminate in O(1) expected rounds.
* **capacity semantics** — ``max_entries`` mirrors the dict version's
  ``LAST_MAX`` cap: beyond it, NEW sessions silently stop being tracked
  (routing is stateless and unaffected); within a batch the insert budget
  is spent in first-occurrence order, exactly like the sequential loop.

``record`` preserves the per-key dict-loop semantics bit-for-bit, counting
each *distinct* moved key once (duplicate keys inside one batch carry the
same replica — routing is deterministic — so the sequential loop also
counts them once).
"""
from __future__ import annotations

import numpy as np

#: free-slot marker in ``_vals`` — replica ids are always >= 0
EMPTY = np.int32(-1)


class SessionStore:
    def __init__(self, max_entries: int = 1 << 20, initial_slots: int = 1 << 10):
        if initial_slots & (initial_slots - 1) or initial_slots < 2:
            raise ValueError(f"initial_slots must be a power of two >= 2, got {initial_slots}")
        self.max_entries = max_entries
        self._keys = np.zeros(initial_slots, dtype=np.uint64)
        self._vals = np.full(initial_slots, EMPTY, dtype=np.int32)
        self.count = 0

    def __len__(self) -> int:
        return self.count

    @staticmethod
    def _home(keys: np.ndarray, mask: int) -> np.ndarray:
        """First probe slot per key: fold the u64 onto the slot space."""
        return ((keys ^ (keys >> np.uint64(32))) & np.uint64(mask)).astype(np.int64)

    def _find(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Bulk lookup: -> (found bool[N], slot int64[N]; slot valid iff found).

        One vectorised gather+compare round per probe distance over the rows
        still unresolved; with load <= 1/2 the expected round count is O(1).
        """
        n = keys.size
        mask = self._keys.size - 1
        home = self._home(keys, mask)
        # round 0 runs on the full arrays with no index indirection — at
        # load <= 1/2 it resolves the large majority of rows, so the
        # fancy-indexed rounds below only ever see a small remainder
        occupied = self._vals[home] != EMPTY  # one gather, reused below
        hit = occupied & (self._keys[home] == keys)
        found = hit
        slot = np.where(hit, home, -1)
        active = np.flatnonzero(occupied & ~hit)  # ~occupied ends the chain
        for j in range(1, self._keys.size):
            if active.size == 0:
                break
            s = (home[active] + j) & mask
            occupied = self._vals[s] != EMPTY
            hit = occupied & (self._keys[s] == keys[active])
            resolved = active[hit]
            found[resolved] = True
            slot[resolved] = s[hit]
            active = active[occupied & ~hit]
        return found, slot

    def _insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Bulk insert of DISTINCT keys known absent from the store."""
        if keys.size == 0:
            return
        if (self.count + keys.size) * 2 > self._keys.size:
            self._grow(self.count + keys.size)
        mask = self._keys.size - 1
        home = self._home(keys, mask)
        active = np.arange(keys.size)
        for j in range(self._keys.size):
            s = (home[active] + j) & mask
            free = self._vals[s] == EMPTY
            cand, sc = active[free], s[free]
            # claim: scatter keys (numpy last-write-wins on duplicate slots),
            # then re-read — the row whose key survived owns the slot
            self._keys[sc] = keys[cand]
            won = self._keys[sc] == keys[cand]
            self._vals[sc[won]] = vals[cand[won]]
            settled = np.zeros(active.size, dtype=bool)
            settled[np.flatnonzero(free)[won]] = True
            active = active[~settled]
            if active.size == 0:
                break
        self.count += keys.size

    def _grow(self, need: int) -> None:
        """Double the slot space until load <= 1/2, rehashing every entry."""
        slots = self._keys.size
        while need * 2 > slots:
            slots *= 2
        live = self._vals != EMPTY
        old_keys, old_vals = self._keys[live], self._vals[live]
        self._keys = np.zeros(slots, dtype=np.uint64)
        self._vals = np.full(slots, EMPTY, dtype=np.int32)
        self.count = 0
        self._insert(old_keys, old_vals)

    def record(self, keys: np.ndarray, replicas: np.ndarray) -> int:
        """Bulk key -> replica update; returns how many tracked keys MOVED.

        Semantics of the sequential dict loop, vectorised: tracked keys whose
        replica changed are counted (once per distinct key) and updated; new
        keys are admitted in first-occurrence order until ``max_entries``;
        keys beyond the cap are ignored.
        """
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        replicas = np.asarray(replicas).astype(np.int32, copy=False).reshape(-1)
        if keys.size == 0:
            return 0
        # probe the RAW batch (duplicates included) and only dedup the rows
        # that need it: in steady state — everything tracked, nothing moved —
        # this is one probe pass and two compares, no O(N log N) sort
        found, slot = self._find(keys)
        moved = found & (self._vals[slot] != replicas)
        n_moved = 0
        if moved.any():
            # duplicate keys carry equal replicas (routing is deterministic),
            # so the scatter is idempotent and each distinct key counts once
            self._vals[slot[moved]] = replicas[moved]
            n_moved = int(np.unique(keys[moved]).size)
        fresh = np.flatnonzero(~found)
        if fresh.size and self.count < self.max_entries:
            # distinct new keys in first-occurrence order (the cap budget is
            # spent in batch order, like the sequential loop)
            uniq, first = np.unique(keys[fresh], return_index=True)
            order = np.argsort(first)[: self.max_entries - self.count]
            self._insert(uniq[order], replicas[fresh[first[order]]])
        return n_moved

    def record_one(self, key: int, replica: int) -> int:
        """Scalar ``record``: one key, plain-int probe loop, no array temps.

        The per-request control-plane path (``SessionRouter.route``) calls
        this instead of paying the vectorised machinery's fixed cost for a
        size-1 batch.  Semantics identical to ``record([key], [replica])``.
        """
        mask = self._keys.size - 1
        key = int(key)
        home = (key ^ (key >> 32)) & mask
        keys, vals = self._keys, self._vals
        for j in range(keys.size):
            s = (home + j) & mask
            if vals[s] == EMPTY:
                if self.count >= self.max_entries:
                    return 0  # past the cap: new keys go untracked
                if (self.count + 1) * 2 > keys.size:
                    self._grow(self.count + 1)
                    return self.record_one(key, replica)  # re-probe, rehashed
                keys[s] = key
                vals[s] = replica
                self.count += 1
                return 0
            if keys[s] == key:
                if vals[s] != replica:
                    vals[s] = replica
                    return 1
                return 0
        return 0  # unreachable at load <= 1/2

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Bulk read: int32 last-known replica per key, EMPTY (-1) if untracked."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        out = np.full(keys.size, EMPTY, dtype=np.int32)
        if keys.size:
            found, slot = self._find(keys)
            out[found] = self._vals[slot[found]]
        return out
