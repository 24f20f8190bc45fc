"""The train step: loss and gradients, microbatch accumulation, gradient
compression, global-norm clipping and the optimizer update — the
counterpart of ``repro.training.train_step`` on one device.

The state is the reference's tree: ``{"params", "opt", "step", "comp_err"
(with compression)}``, ``params`` in the stacked layout of
``repro_torch.models.model`` and ``step`` a 0-dim int32 tensor on the
parameters' device.  ``train_step`` updates it in place and returns it
with the step's metrics (0-dim tensors, still on the device: nothing in a
step waits for the device).  Gradients come from ``torch.autograd.grad``
on detached views of the parameters, so the state never holds autograd
history; a parameter the loss does not reach (the score router's weights
under the hash router) gets a zero gradient, as ``jax.grad`` gives.  With
``grad_accum > 1`` each microbatch's gradients are added into float32
buffers, as the reference's scan adds them into float32 zeros, so the
optimizer sees float32 gradients there and parameter-dtype ones without
accumulation, in both packages.  The three parts of a step run under
``torch.profiler.record_function`` ranges (``train_step/grads``,
``train_step/clip``, ``train_step/optimizer``), which a profiler reads and
which cost nothing measurable otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.training import compression as C
from repro_torch.training.optimizer import flat_slices
from repro_torch.tree import leaves, unflatten


@dataclass(frozen=True)
class TrainHparams:
    grad_accum: int = 1
    clip_norm: float = 1.0
    compression: str = "none"  # none | int8 | topk


def _clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / global norm), in place
    (through float32 for a narrower dtype). -> (grads, the norm)."""
    flat = leaves(grads)
    gn = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for g in flat:
        gn = gn + sum(s.float().square().sum() for (s,) in flat_slices(g))
    gn = gn.sqrt()
    scale = (torch.tensor(max_norm, dtype=torch.float32, device=gn.device)
             / gn.clamp(min=1e-12)).clamp(max=1.0)
    with torch.no_grad():
        for g in flat:
            for (s,) in flat_slices(g):
                s.copy_(s.float() * scale)
    return grads, gn


def make_train_state(params, optimizer, hp: TrainHparams = TrainHparams()) -> dict:
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}
    if hp.compression != "none":
        state["comp_err"] = C.init_error_state(params)
    return state


def _split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """One batch leaf -> ``n`` microbatches along the batch axis (axis 1 of
    M-RoPE positions (3, B, S), taken to be any leaf with a leading 3, as
    the reference takes it)."""
    if x.ndim >= 2 and x.shape[0] == 3:
        return list(x.reshape(3, n, x.shape[1] // n, *x.shape[2:]).movedim(1, 0))
    return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]))


def loss_and_grads(params, batch, cfg: ArchConfig):
    """-> (loss, metrics, gradients in flatten order) of ``model.loss_fn``
    at ``params``, which are left without autograd history."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    loss, metrics = M.loss_fn(unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, optimizer, hp: TrainHparams = TrainHparams()):
    """-> ``train_step(state, batch) -> (state, metrics)``: metrics
    ``{ce, aux, [mtp_ce], loss, grad_norm}``, or ``{loss, grad_norm}`` with
    ``grad_accum > 1``, as the reference's."""

    def train_step(state, batch):
        params = state["params"]
        with record_function("train_step/grads"):
            grads, metrics = _grads(params, batch)
        with record_function("train_step/clip"):
            if hp.compression != "none":
                grads, state["comp_err"] = C.apply_compression(grads, state["comp_err"],
                                                               hp.compression)
            grads, gn = _clip_by_global_norm(grads, hp.clip_norm)
        with record_function("train_step/optimizer"):
            state["params"], state["opt"] = optimizer.update(grads, state["opt"], params,
                                                             state["step"])
        state["step"] = state["step"] + 1
        metrics["grad_norm"] = gn
        return state, metrics

    def _grads(params, batch):
        """-> (gradient tree, metrics): one batch, or the mean over
        ``grad_accum`` microbatches accumulated in float32."""
        if hp.grad_accum > 1:
            n = hp.grad_accum
            parts = {k: _split(v, n) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(n):
                mb = {k: v[i] for k, v in parts.items()}
                mb_loss, _, mb_grads = loss_and_grads(params, mb, cfg)
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g)
                loss = loss + mb_loss
                del mb_grads
            count = torch.tensor(float(n), device=loss.device)
            for acc in grads:
                acc.div_(count)
            metrics = {"loss": loss / count}
        else:
            _, metrics, grads = loss_and_grads(params, batch, cfg)
        return unflatten(params, grads), metrics

    return train_step


def make_serve_steps(cfg: ArchConfig, max_len: int):
    """-> (prefill_fn, decode_fn) with the model closed over cfg; both take
    the train state's stacked parameters (read through
    ``model.per_layer``'s views)."""

    def prefill_fn(params, batch):
        return M.prefill(M.per_layer(params, cfg), batch, cfg, max_len)

    def decode_fn(params, cache, batch):
        return M.decode_step(M.per_layer(params, cfg), cache, batch, cfg)

    return prefill_fn, decode_fn
