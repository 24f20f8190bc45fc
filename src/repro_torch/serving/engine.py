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
kernels' plain versions).  ``attach_lifecycle`` wraps the router in a
``LifecycleManager``: heartbeats then flow through ``heartbeat``, every
``serve`` ticks the failure detector first, and fleet events are journaled.

Handed a ``mesh`` (a ``DeviceMesh``), the tier shards the routing datapath
over the mesh's ranks: key batches are split over ``shard_axis``, the
fleet state is whole on every rank (DESIGN.md §8), and every rank runs
the same requests and fleet events.  ``router_spec`` gives the whole
``RouterSpec`` instead of ``engine`` and ``shard_axis`` (both at once is an
error).  The model layers run under a mesh only inside
``repro_torch.sharding.rules.mesh_context``, with each rank holding its
block of the parameters (``interop.params_from_numpy(..., local=True)``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.lifecycle import LifecycleManager


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
        engine: str | None = None, device=None, mesh=None,
        shard_axis: str | None = None, router_spec=None,
    ):
        self.cfg = cfg
        self.max_len = max_len
        # a full RouterSpec carries engine and shard_axis itself, so
        # combining it with either keyword is a conflict, not a merge
        if router_spec is not None:
            clash = [k for k, v in (("engine", engine), ("shard_axis", shard_axis))
                     if v is not None]
            if clash:
                raise ValueError(
                    f"pass either router_spec or {clash}, not both — the "
                    "spec already carries those fields"
                )
            self.router = BatchRouter(n_replicas, router_spec, mesh=mesh, device=device)
        else:
            self.router = BatchRouter(
                n_replicas, engine="binomial" if engine is None else engine, mesh=mesh,
                shard_axis="data" if shard_axis is None else shard_axis, device=device,
            )
        self.device = self.router.device
        self.replicas = [self._replica(params) for _ in range(n_replicas)]
        #: optional lifecycle robustness layer (``attach_lifecycle``)
        self.lifecycle = None

    def attach_lifecycle(self, config=None, clock=None):
        """Wrap the router in a ``LifecycleManager`` (DESIGN.md §12).

        Heartbeats then flow through ``tier.heartbeat(slot)``, and every
        ``serve`` first ticks the failure detector — expirations land as
        ONE coalesced device-state update before the batch is routed.
        """
        self.lifecycle = LifecycleManager(self.router, config=config, clock=clock)
        return self.lifecycle

    def heartbeat(self, replica: int) -> None:
        if self.lifecycle is None:
            raise RuntimeError("call attach_lifecycle() before heartbeat()")
        self.lifecycle.heartbeat(replica)

    def _replica(self, params) -> Replica:
        return Replica(self.cfg, params, self.max_len, self.device)

    def serve(self, requests: list[Request]) -> dict[str, np.ndarray]:
        """Route the whole batch in one launch, group, serve aligned (prompts
        left-padded with 0 to the group's longest).  With a lifecycle
        attached, detector expirations are applied (coalesced) before
        routing; an all-failed fleet raises ``FleetUnavailableError``."""
        if self.lifecycle is not None:
            self.lifecycle.tick()
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

    # Fleet events go through the lifecycle manager when one is attached
    # (journaled, detector-aligned, placement-synced) and to the raw router
    # otherwise.  The replica list stays (dead ones idle), except that
    # failing the LAST slot is a true LIFO retirement that shrinks the slot
    # space.
    def _events(self):
        return self.router if self.lifecycle is None else self.lifecycle

    def fail(self, replica: int) -> None:
        self._events().fail(replica)
        del self.replicas[self.router.domain.total_count:]

    def recover(self, replica: int) -> None:
        self._events().recover(replica)

    def scale_up(self, params) -> int:
        """Append a replica serving ``params``; only movers re-prefill."""
        if len(self.replicas) != self.router.domain.total_count:
            raise RuntimeError(
                f"replica list ({len(self.replicas)}) out of lockstep with "
                f"router slot space ({self.router.domain.total_count})"
            )
        new = self._events().scale_up()
        self.replicas.append(self._replica(params))
        return new

    def scale_down(self) -> int:
        """Retire the last replica (LIFO, per the paper's operating model)."""
        gone = self._events().scale_down()
        # the router may garbage-collect failed tombstones off the end too
        del self.replicas[self.router.domain.total_count:]
        return gone
