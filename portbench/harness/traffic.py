"""The one traffic generator: everything a run sends is drawn from
``--seed`` and the parameters of its traffic file.

* the key pool: ``pool_batches`` batches of ``batch_keys`` uniform u32 keys,
  made on the device in one call (cycled so that no batch is served from
  the card's cache);
* the fleet events: the failures at the start and the bursts of the
  window, alternating a failure and the recovery of the same slots;
* the sample of answers compared after the window.

Every seed gets the same sizes and the same cadence; only which keys and
which slots differ.  No event touches the last slot, whose removal is a
scale-down and not a failure.
"""
from __future__ import annotations

import random

import numpy as np
import torch

KEYS, EVENTS, SAMPLES = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one stream of a run's randomness."""
    state = np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def key_pool(seed: int, workload: dict, device) -> torch.Tensor:
    """``(pool_batches, batch_keys)`` int32 tensor of u32 bit patterns."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, KEYS))
    shape = (workload["pool_batches"], workload["batch_keys"])
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen, device=device)


class Schedule:
    """The fleet events of one run over ``n`` slots; ``start()`` once, then
    ``burst()`` for each burst in order."""

    def __init__(self, seed: int, workload: dict, n: int):
        self.rng = random.Random(sub_seed(seed, EVENTS))
        self.start_spec = workload.get("start", {})
        self.burst_spec = workload.get("bursts")
        self.n = n
        self.failed: set[int] = set()
        self._down: list[int] = []

    @property
    def every_s(self) -> float | None:
        return None if self.burst_spec is None else float(self.burst_spec["every_s"])

    def _fail(self, slots) -> list:
        self.failed.update(slots)
        return [("fail", s) for s in slots]

    def start(self) -> list:
        """``failed`` slots drawn at random."""
        return self._fail(self.rng.sample(range(self.n - 1), self.start_spec.get("failed", 0)))

    def burst(self) -> list:
        """A failure of ``size`` alive slots drawn at random, or the
        recovery of the last failure's slots, in turn."""
        if self._down:
            down, self._down = self._down, []
            self.failed.difference_update(down)
            return [("recover", s) for s in down]
        alive = sorted(set(range(self.n - 1)) - self.failed)
        self._down = self.rng.sample(alive, self.burst_spec["size"])
        return self._fail(self._down)


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    the seed: after ``m`` offers each is kept with probability ``k / m``."""

    def __init__(self, seed: int, k: int, stream: int = SAMPLES):
        self.rng = random.Random(sub_seed(seed, stream))
        self.k = k
        self.seen = 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item
