"""Batched serving engine + replicated serving tier — the counterpart of
``repro.serving.engine``.

Each ``Replica`` serves aligned batches with the model's parameters:
prefill the batch of prompts, then decode step by step (greedy).  The
``ServingTier`` composes replicas with the BinomialHash ``BatchRouter``:
the whole request batch is routed in ONE kernel launch, grouped by routed
replica, each replica serves its group, and fleet events (fail, recover,
scale) move only the sessions the paper's guarantees say they may.  Every
replica serves the same parameter tensors; none copies them.

Runs on the CUDA device unless ``device`` names another (``"cpu"`` runs the
kernels' plain versions).  Not ported yet: ``attach_lifecycle`` and
``heartbeat`` (ROADMAP Queue 1, item 6), ``mesh`` and ``router_spec``
(item 13).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.batch_router import BatchRouter


class Replica:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 64, device=None):
        self.device = resolve_device(device)
        held = params["embed"]["embedding"].device
        if held.type != self.device.type:
            raise ValueError(f"params lie on {held}, the replica runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.steps_served = 0

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts (B, S0) int -> generated (B, n_new) int32 greedy tokens."""
        tokens = torch.as_tensor(np.asarray(prompts, dtype=np.int64), device=self.device)
        cache, logits = M.prefill(self.params, {"tokens": tokens}, self.cfg, self.max_len)
        outs = []
        for _ in range(n_new):
            nxt = logits.argmax(-1)[:, None]
            outs.append(nxt)
            cache, logits = M.decode_step(self.params, cache, {"tokens": nxt}, self.cfg)
            self.steps_served += 1
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)


@dataclass
class Request:
    session_id: str
    prompt: np.ndarray  # (S0,)
    n_new: int = 8


class ServingTier:
    def __init__(
        self, cfg: ArchConfig, params, n_replicas: int, max_len: int = 64,
        engine: str = "binomial", device=None,
    ):
        self.cfg = cfg
        self.max_len = max_len
        self.router = BatchRouter(n_replicas, engine=engine, device=device)
        self.device = self.router.device
        self.replicas = [self._replica(params) for _ in range(n_replicas)]

    def _replica(self, params) -> Replica:
        return Replica(self.cfg, params, self.max_len, self.device)

    def serve(self, requests: list[Request]) -> dict[str, np.ndarray]:
        """Route the whole batch in one launch, group, serve aligned (prompts
        left-padded with 0 to the group's longest)."""
        if not requests:
            return {}
        replicas = self.router.route_batch([r.session_id for r in requests])
        groups: dict[int, list[Request]] = {}
        for r, rep_id in zip(requests, replicas):
            groups.setdefault(int(rep_id), []).append(r)
        results: dict[str, np.ndarray] = {}
        for rep_id, group in groups.items():
            s0 = max(len(g.prompt) for g in group)
            n_new = max(g.n_new for g in group)
            prompts = np.stack(
                [np.pad(g.prompt, (s0 - len(g.prompt), 0), constant_values=0) for g in group]
            )
            gen = self.replicas[rep_id].generate(prompts, n_new)
            for g, row in zip(group, gen):
                results[g.session_id] = row[: g.n_new]
        return results

    # The replica list stays (dead ones idle), except that failing the LAST
    # slot is a true LIFO retirement that shrinks the slot space.
    def fail(self, replica: int) -> None:
        self.router.fail(replica)
        del self.replicas[self.router.domain.total_count:]

    def recover(self, replica: int) -> None:
        self.router.recover(replica)

    def scale_up(self, params) -> int:
        """Append a replica serving ``params``; only movers re-prefill."""
        if len(self.replicas) != self.router.domain.total_count:
            raise RuntimeError(
                f"replica list ({len(self.replicas)}) out of lockstep with "
                f"router slot space ({self.router.domain.total_count})"
            )
        new = self.router.scale_up()
        self.replicas.append(self._replica(params))
        return new

    def scale_down(self) -> int:
        """Retire the last replica (LIFO, per the paper's operating model)."""
        gone = self.router.scale_down()
        # the router may garbage-collect failed tombstones off the end too
        del self.replicas[self.router.domain.total_count:]
        return gone
