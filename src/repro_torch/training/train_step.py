"""The train step: loss and gradients, microbatch accumulation, gradient
compression, global-norm clipping and the optimizer update — the
counterpart of ``repro.training.train_step``, on one device and under a
mesh.

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
accumulation, in both packages.  The parts of a step run under
``torch.profiler.record_function`` ranges (``train_step/grads``,
``train_step/clip``, ``train_step/optimizer``; with compression
``train_step/compress`` inside the clip's range), which a profiler reads and which cost nothing
measurable otherwise.  The clip computes the global norm and its scale;
AdamW applies the scale inside its update (so the clip's range holds the
norm alone), Adafactor is handed gradients the clip scaled in place.

Under a mesh (the state made and the step called inside
``rules.mesh_context`` with a ``DeviceMesh``) ``make_train_state`` takes the
full parameters (on any device, ``meta`` included) and the state holds this
rank's blocks of them (``rules.params_local``; a block smaller than its
leaf gets its own storage) and its ZeRO-1 blocks of the optimizer state
(``optimizer.Zero1``, built from the full shapes); the batch is the rank's
data shard, and with ``grad_accum > 1`` the shard holds each microbatch's
data shard in turn (``shard_batch``), so microbatch ``i`` of every rank is
the reference's microbatch ``i``.  One step serves both cases: the loss and
the gradients of the blocks (``model.loss_fn``'s convention), each leaf's
gradient summed over the data axes it is replicated on and cut to its
ZeRO-1 block, the global norm from the blocks, the clip, the optimizer on
the blocks, and the updated blocks all-gathered over ``data`` into the
parameters' own layout.  With no mesh ``Zero1`` is the identity: every
block is the whole leaf and nothing is summed, cut or gathered.  Gradient
compression runs on the ZeRO-1 blocks of the summed gradient, before the
clip, as the reference compresses its global gradient before its clip
(``compression``: each hook reduces over the axes that cut the leaf, so it
computes the whole leaf's scale or top-k threshold); ``comp_err`` holds
this rank's float32 ZeRO-1 block of each leaf's residual.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.training import compression as C
from repro_torch.models.layers.common import MetaGenerator
from repro_torch.sharding import rules
from repro_torch.training.optimizer import AdamW, Zero1, flat_slices
from repro_torch.tree import flatten_with_path, leaves, unflatten


@dataclass(frozen=True)
class TrainHparams:
    grad_accum: int = 1
    clip_norm: float = 1.0
    compression: str = "none"  # none | int8 | topk


def _clip_scale(max_norm: float, gn: torch.Tensor) -> torch.Tensor:
    """The clip's scale, min(1, max_norm / gn): a float32 0-dim tensor on
    ``gn``'s device."""
    return (torch.full((), max_norm, dtype=torch.float32, device=gn.device)
            / gn.clamp(min=1e-12)).clamp(max=1.0)


def _scale_to(flat, max_norm: float, gn: torch.Tensor) -> None:
    """Scale every gradient of ``flat`` by min(1, max_norm / gn), in place
    (through float32 for a narrower dtype)."""
    scale = _clip_scale(max_norm, gn)
    with torch.no_grad():
        for g in flat:
            for (s,) in flat_slices(g):
                s.copy_(s.float() * scale)


def zero1_layout(cfg: ArchConfig) -> Zero1:
    """The ZeRO-1 layout of ``cfg``'s train state under the active mesh
    (from its parameters' shapes on ``meta``; the identity with none)."""
    return Zero1(M.init_train_params(MetaGenerator(), cfg))


def make_train_state(params, optimizer, hp: TrainHparams = TrainHparams()) -> dict:
    """The state over ``params``.  Under a mesh ``params`` are the full
    parameters and the state holds this rank's blocks of them and its
    ZeRO-1 blocks of the optimizer state (see the module docstring)."""
    zero1 = Zero1(params)
    if rules.current_mesh() is not None:
        local = leaves(rules.params_local(params))
        params = unflatten(params, [b if b.numel() == p.numel() else b.clone()
                                    for p, b in zip(leaves(params), local)])
    flat = leaves(params)
    blocks = [zero1.param_block(i, p) for i, p in enumerate(flat)]
    state = {"params": params, "opt": optimizer.init(unflatten(params, blocks)),
             "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}
    if hp.compression != "none":
        state["comp_err"] = C.init_error_state(unflatten(params, blocks))
    return state


def _split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """One batch leaf -> ``n`` microbatches along the batch axis (axis 1 of
    M-RoPE positions (3, B, S), taken to be any leaf with a leading 3, as
    the reference takes it)."""
    if x.ndim >= 2 and x.shape[0] == 3:
        return list(x.reshape(3, n, x.shape[1] // n, *x.shape[2:]).movedim(1, 0))
    return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]))


def shard_batch(batch: dict, grad_accum: int = 1) -> dict:
    """A global batch -> this rank's data shard under the active mesh: each
    of the ``grad_accum`` microbatches cut over the data axes
    (``rules.batch_pspecs``), the shards put back in microbatch order."""
    out = {}
    mesh = rules.current_mesh()
    for k, v in batch.items():
        parts = _split(v, grad_accum)
        axis = 1 if v.ndim >= 2 and v.shape[0] == 3 else 0
        spec = rules.batch_pspecs({k: parts[0]})[k]
        cut = [rules.local_slice(p, spec, mesh) for p in parts]
        out[k] = torch.cat(cut, dim=axis) if len(cut) > 1 else cut[0]
    return out


def unreached(cfg: ArchConfig) -> tuple:
    """The path endings of the leaves ``cfg``'s loss does not reach, whose
    gradient is zero (``jax.grad`` gives zeros): the score router's weights
    under the hash router, the sigmoid router's selection bias (it only
    orders the experts), and an embeds-input model's untied embedding."""
    out = []
    if cfg.moe is not None and cfg.moe.router == "hash":
        out.append("['router']")
    if cfg.moe is not None and cfg.moe.router == "sigmoid":
        out.append("['router_bias']")
    if cfg.input_mode != "tokens" and not cfg.tie_embeddings:
        out.append("['embed']['embedding']")
    return tuple(out)


def loss_and_grads(params, batch, cfg: ArchConfig):
    """-> (loss, metrics, gradients in flatten order) of ``model.loss_fn``
    at ``params``, which are left without autograd history.  A leaf that
    gets no gradient gets zeros; under a mesh only the ``unreached`` ones
    may, and any other raises (a collective without a gradient rule would
    otherwise train nothing silently)."""
    flat = flatten_with_path(params)
    live = [p.detach().requires_grad_() for _, p in flat]
    loss, metrics = M.loss_fn(unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    if rules.current_mesh() is not None:
        missing = [path for (path, _), g in zip(flat, grads)
                   if g is None and not path.endswith(unreached(cfg))]
        if missing:
            raise RuntimeError(f"the loss reached no gradient to {missing[:4]}")
    grads = [torch.zeros_like(p) if g is None else g for g, (_, p) in zip(grads, flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, optimizer, hp: TrainHparams = TrainHparams()):
    """-> ``train_step(state, batch) -> (state, metrics)``: metrics
    ``{ce, aux, [mtp_ce], loss}``, or ``{loss}`` with ``grad_accum > 1``,
    as the reference's, plus ``grad_norm``.  Under a mesh the step is the
    meshed one (see the module docstring).  Its ZeRO-1 layout is built
    here, for the active mesh context (outside any step a caller traces or
    times: the build initialises the parameters on ``meta``), and the step
    raises under another context."""
    made_in = (rules.current_mesh(), rules.fsdp(), rules.expert_layout())
    zero1 = zero1_layout(cfg)
    # AdamW applies the clip's scale inside its own pass over the gradients
    # (one read of each, no scaled copy written); Adafactor gets them scaled
    fold = isinstance(optimizer, AdamW)

    def train_step(state, batch):
        now = (rules.current_mesh(), rules.fsdp(), rules.expert_layout())
        if now[0] is not made_in[0] or now[1:] != made_in[1:]:
            raise RuntimeError("a train step runs under the mesh context it was made in")
        params = state["params"]
        flat = leaves(params)
        with record_function("train_step/grads"):
            grads, metrics = _grads(params, batch)
        with record_function("train_step/clip"):
            blocks = [zero1.grad_block(i, g) for i, g in enumerate(leaves(grads))]
            del grads
            if hp.compression != "none":
                with record_function("train_step/compress"):
                    blocks = _compress(blocks, state)
            gn = zero1.global_norm(blocks)
            if not fold:
                _scale_to(blocks, hp.clip_norm, gn)
        with record_function("train_step/optimizer"):
            p_blocks = [zero1.param_block(i, p) for i, p in enumerate(flat)]
            scale = {"grad_scale": _clip_scale(hp.clip_norm, gn)} if fold else {}
            optimizer.update(unflatten(params, blocks), state["opt"], unflatten(params, p_blocks),
                             state["step"], cuts=zero1.cuts, **scale)
            with torch.no_grad():
                for i, (p, b) in enumerate(zip(flat, p_blocks)):
                    zero1.put_back(i, p, b)
        state["step"] = state["step"] + 1
        metrics["grad_norm"] = gn
        return state, metrics

    def _compress(blocks, state):
        """The compressed gradient blocks, each gradient block dropped from
        ``blocks`` once compressed; the new residuals are written into
        ``state["comp_err"]`` in place (so one residual of a leaf is alive
        at a time, not the old and the new)."""
        out = []
        with torch.no_grad():
            for i, err in enumerate(leaves(state["comp_err"])):
                c, new = C.compress(hp.compression, blocks[i], err, math.prod(zero1.shapes[i]),
                                    zero1.axes(i))
                blocks[i] = None
                err.copy_(new)
                out.append(c)
        return out

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
