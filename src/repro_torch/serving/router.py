"""Serving-tier request router built on BinomialHash + Memento failures.

Sessions (chat threads / users) are routed to replicas by consistent hashing
so that (a) load is balanced (paper Eq. 3 bound), (b) a session sticks to its
replica across requests — KV-cache / prefix-cache affinity — and (c) scaling
the replica fleet up/down or losing a replica moves only the minimal set of
sessions (whose prefixes must be re-prefetched; everyone else's cache stays
hot).

Two tiers share this architecture:

* ``SessionRouter`` (this module) — the scalar control plane: one Python
  lookup per call through ``FailureDomain.locate``.  With
  ``engine="binomial32", chain_bits=32, resolve="table"`` it is the
  bit-exact oracle for the batched datapath (``resolve="chain"``, the
  default, keeps the paper-faithful rejection-chain flavour).
* ``BatchRouter`` (``repro_torch.serving.batch_router``) — the device datapath:
  whole request batches flow through the fused lookup+divert kernel
  (fleet state, removed-slot mask and replacement table as fixed-capacity
  device tensors — DESIGN.md §3, §7).
  Fleet events mutate only small traced operands, so scale/fail streams
  never retrace or recompile, and the bounded table divert keeps storm-time
  batch cost equal to steady-time cost.

Session-id ingest is batched too (DESIGN.md §9): ``hash_session_ids``
vectorises ``session_key`` over whole request batches (padded byte-matrix
FNV-1a for strings, ``np_mix64`` for ints — bit-exact with the scalar
loop), and movement observability flows through the bulk open-addressing
``SessionStore`` instead of a per-key dict walk.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import bits
from repro_torch.placement.elastic import FailureDomain
from repro_torch.serving.lifecycle.errors import FleetUnavailableError
from repro_torch.serving.session_store import SessionStore


def encode_session_ids(session_ids) -> tuple[np.ndarray, np.ndarray]:
    """String session ids -> padded ``(N, L)`` uint8 byte matrix + lengths.

    Two constructions, picked per batch:

    * **ASCII fast path** — join the whole batch and UTF-8 encode ONCE (two
      C calls); if the byte count equals the char count the batch is pure
      ASCII, so per-id char lengths are byte lengths and the flat buffer
      slices straight into rows: a free ``reshape`` when every id has the
      same length (the common shape), one masked scatter otherwise.
    * **general path** — UTF-8 encode each id (the one remaining per-item
      Python step), then let numpy's fixed-width bytes dtype pad the rows
      into a zero-filled matrix.

    Rows are byte prefixes + zero padding either way, so ``bits.np_fnv1a64``
    can hash the whole batch in L masked column passes.  Raises TypeError
    for non-str elements (the callers' mixed-batch fallback signal).
    """
    n = len(session_ids)
    lengths = np.fromiter(map(len, session_ids), dtype=np.int64, count=n)
    if n == 0:
        return np.zeros((0, 0), dtype=np.uint8), lengths
    joined = "".join(session_ids)
    raw = joined.encode()
    if len(raw) == len(joined):  # pure ASCII: char lengths ARE byte lengths
        flat = np.frombuffer(raw, dtype=np.uint8)
        max_len = int(lengths.max())
        if max_len == 0:
            return np.zeros((n, 0), dtype=np.uint8), lengths
        if (lengths == max_len).all():
            return flat.reshape(n, max_len), lengths
        mat = np.zeros((n, max_len), dtype=np.uint8)
        mat[np.arange(max_len) < lengths[:, None]] = flat
        return mat, lengths
    # non-ASCII: UTF-8 byte lengths differ from char counts — encode per id
    encoded = list(map(str.encode, session_ids))
    lengths = np.fromiter(map(len, encoded), dtype=np.int64, count=n)
    max_len = int(lengths.max())
    mat = (
        np.array(encoded, dtype=f"S{max_len}").view(np.uint8).reshape(n, max_len)
    )
    return mat, lengths


def _hash_str_batch(session_ids) -> np.ndarray:
    mat, lengths = encode_session_ids(session_ids)
    return bits.np_fnv1a64(mat, lengths)


def _hash_int_batch(session_ids) -> np.ndarray:
    # mask to the u64 key space exactly like the scalar oracle (mix64 wraps);
    # raises TypeError for str elements (the mixed-batch fallback signal)
    ints = np.fromiter(
        (i & bits.MASK64 for i in session_ids), dtype=np.uint64, count=len(session_ids)
    )
    return bits.np_mix64(ints)


def hash_session_ids(session_ids) -> np.ndarray:
    """Vectorised ``SessionRouter.session_key`` over a whole batch.

    Accepts an int ndarray (``np_mix64`` directly, zero per-item Python), or
    a sequence of str / int session ids (mixed freely); returns the uint64
    session keys, bit-exact with the scalar ``session_key`` per element.

    Type dispatch costs nothing extra on homogeneous batches: the hash path
    matching the first element is attempted outright, and its own length /
    mask pass doubles as the type check (a TypeError from a mismatched
    element falls back to the partition-and-reinterleave path).
    """
    if isinstance(session_ids, np.ndarray):
        if session_ids.dtype.kind in "iu":
            return bits.np_mix64(session_ids.astype(np.uint64, copy=False))
        session_ids = session_ids.tolist()
    elif not isinstance(session_ids, (list, tuple)):
        # accept any iterable (generators, sets, ...) like the scalar
        # per-item loop this replaced — the batch paths need len + indexing
        session_ids = list(session_ids)
    n = len(session_ids)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    try:
        if isinstance(session_ids[0], str):
            return _hash_str_batch(session_ids)
        return _hash_int_batch(session_ids)
    except TypeError:
        pass
    # mixed batch: partition by type, hash each side, re-interleave
    is_str = np.fromiter(
        (isinstance(s, str) for s in session_ids), dtype=bool, count=n
    )
    out = np.empty(n, dtype=np.uint64)
    s_idx = np.flatnonzero(is_str)
    i_idx = np.flatnonzero(~is_str)
    if s_idx.size:
        out[s_idx] = _hash_str_batch([session_ids[i] for i in s_idx])
    if i_idx.size:
        out[i_idx] = _hash_int_batch([session_ids[i] for i in i_idx])
    return out


@dataclass
class RoutingStats:
    lookups: int = 0
    moved_sessions: int = 0
    events: list = field(default_factory=list)


class SessionRouter:
    def __init__(
        self,
        n_replicas: int,
        engine: str = "binomial",
        chain_bits: int = 64,
        omega: int | None = None,
        max_chain: int = 4096,
        resolve: str = "chain",
        allow_empty: bool = False,
    ):
        self.domain = FailureDomain(
            n_replicas,
            engine,
            chain_bits=chain_bits,
            omega=omega,
            max_chain=max_chain,
            resolve=resolve,
            allow_empty=allow_empty,
        )
        self.stats = RoutingStats()
        #: session key -> last replica (observability only): bulk
        #: open-addressing store, vectorised probe/insert (DESIGN.md §9)
        self._last = SessionStore(max_entries=self.LAST_MAX)

    @staticmethod
    def session_key(session_id: str | int) -> int:
        if isinstance(session_id, str):
            h = bits.FNV64_OFFSET
            for b in session_id.encode():
                h = ((h ^ b) * bits.FNV64_PRIME) & bits.MASK64
            return h
        return bits.mix64(session_id)

    def route(self, session_id: str | int) -> int:
        if self.domain.alive_count == 0:
            raise FleetUnavailableError()
        key = self.session_key(session_id)
        replica = self.domain.locate(key)
        self.stats.lookups += 1
        self.note_routes((key,), (replica,))
        return replica

    #: cap on the observability store: beyond this many distinct sessions,
    #: NEW sessions are no longer movement-tracked (routing itself is
    #: stateless and unaffected) — bounds resident memory over long serving
    #: lifetimes
    LAST_MAX = 1 << 20

    def note_routes(self, keys, replicas) -> None:
        """Bulk observability update: record key -> replica, count movers.

        Used by the batched datapath (``BatchRouter.route_batch``) so the
        ``moved_sessions`` metric keeps working when routing bypasses the
        scalar ``route``.  One vectorised ``SessionStore.record`` call — no
        per-key Python, so at ingest batch sizes this is noise next to the
        routing dispatch itself; single-key calls (the scalar ``route``
        path) take the plain-int probe instead of paying the vectorised
        machinery's fixed cost.
        """
        if len(keys) == 1:
            self.stats.moved_sessions += self._last.record_one(
                int(keys[0]), int(replicas[0])
            )
            return
        self.stats.moved_sessions += self._last.record(
            np.asarray(keys, dtype=np.uint64),
            np.asarray(replicas),
        )

    # -- fleet events -----------------------------------------------------------
    def scale_up(self) -> int:
        r = self.domain.scale_up()
        self.stats.events.append(("scale_up", r))
        return r

    def scale_down(self) -> int:
        r = self.domain.scale_down()
        self.stats.events.append(("scale_down", r))
        return r

    def fail(self, replica: int) -> None:
        self.domain.fail(replica)
        self.stats.events.append(("fail", replica))

    def recover(self, replica: int) -> None:
        self.domain.recover(replica)
        self.stats.events.append(("recover", replica))

    @property
    def alive(self) -> int:
        return self.domain.alive_count
