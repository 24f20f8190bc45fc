"""Deterministic synthetic LM data pipeline with consistent-hash sharding —
the counterpart of ``repro.data.pipeline``, bit for bit.

The corpus is a virtual set of ``num_shards`` file shards; shard -> host
assignment goes through BinomialHash (``placement.assignment.Assignment``),
so host joins and leaves move the fewest shards, and a straggler's shards
are re-hosted deterministically (``binomial_rehost``).  Token streams come
from splitmix64 counters, so any (shard, step) pair is reproducible on any
host.  Batches are numpy int32, as the reference's are; the trainer moves
them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import bits
from repro_torch.core.binomial import binomial_lookup64
from repro_torch.placement.assignment import Assignment


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1024
    seed: int = 0


class ShardedDataPipeline:
    """Yields {tokens, targets} batches for one host of an elastic fleet."""

    def __init__(self, cfg: DataConfig, num_hosts: int, host_id: int):
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.assignment = Assignment(list(range(cfg.num_shards)), num_hosts, "binomial")
        self._refresh_local()

    def _refresh_local(self):
        table = self.assignment.table()
        self.local_shards = sorted(k for k, h in table.items() if h == self.host_id)

    # -- elasticity -----------------------------------------------------------
    def rescale(self, new_num_hosts: int):
        """Returns the movement plan; only moved shards change hosts."""
        plan = self.assignment.resize(new_num_hosts)
        self.num_hosts = new_num_hosts
        self._refresh_local()
        return plan

    def steal_from(self, straggler_host: int, fraction: float = 0.5):
        """Straggler mitigation: deterministically take over a fraction of a
        slow host's shards (every healthy host computes the same plan)."""
        table = self.assignment.table()
        theirs = sorted(k for k, h in table.items() if h == straggler_host)
        stolen = [
            s
            for s in theirs
            if bits.mix64(s) % 1000 < fraction * 1000
            and binomial_rehost(s, self.num_hosts, straggler_host) == self.host_id
        ]
        self.local_shards = sorted(self.local_shards + stolen)
        return stolen

    # -- batches ----------------------------------------------------------------
    def _shard_tokens(self, shard: int, step: int, n: int) -> np.ndarray:
        base = bits.mix64((shard << 32) ^ step ^ (self.cfg.seed * bits.GOLDEN64))
        out = np.empty(n, dtype=np.int64)
        x = base
        for i in range(n):
            x = bits.mix64(x + bits.GOLDEN64)
            out[i] = x % self.cfg.vocab_size
        return out

    def local_batch_size(self) -> int:
        return self.cfg.global_batch // self.num_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for (host, step): rows round-robin over the
        host's shards."""
        bs = self.local_batch_size()
        L = self.cfg.seq_len
        rows = []
        for r in range(bs):
            shard = self.local_shards[(step * bs + r) % max(len(self.local_shards), 1)]
            rows.append(self._shard_tokens(shard, step * bs + r, L + 1))
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}


def binomial_rehost(shard: int, n_hosts: int, excluded: int) -> int:
    """Deterministic re-host of a shard avoiding ``excluded`` (rejection chain)."""
    h = binomial_lookup64(bits.mix64(shard), n_hosts)
    i = 1
    while h == excluded:
        h = binomial_lookup64(bits.hash_iter64(shard, i), n_hosts)
        i += 1
    return h
