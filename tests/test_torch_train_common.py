"""What the training tests share (this module holds no test of its own):
the reduced configs of both packages, the reference's parameters and
jitted ``value_and_grad`` of its ``loss_fn`` (cached per arch and MoE
fields), seeded numpy batches, the port's loss and gradients under
autograd, the comparison, and the lockstep of the two packages' train
steps (``run_steps``).

Tolerance: every metric and every gradient leaf within 1e-4 of max(1,
max |reference|) — the sums run in another order and the reference's
attention is an online softmax over KV chunks.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TT  # noqa: E402
from repro_torch.training.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import flatten_with_path, unflatten  # noqa: E402

TOL = 1e-4
BATCH, SEQ = 2, 24  # past the reduced window of 16; three SSD chunks of 8


def _configs(arch: str, **fields):
    """The reference's and the port's reduced config, with ``fields``
    replaced (``moe`` given as a dict of MoE fields)."""
    out = []
    for make in (ref_reduced_config, reduced_config):
        cfg = make(arch)
        moe = fields.get("moe")
        rest = {k: v for k, v in fields.items() if k != "moe"}
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(dataclasses.replace(cfg, **rest))
    return out


@functools.cache
def _reference_params(arch: str):
    cfg = ref_reduced_config(arch)
    params = jax.jit(functools.partial(JM.init_params, cfg=cfg))(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@functools.cache
def _reference_grad(arch: str, moe: tuple = ()):
    """The reference's jitted value_and_grad of ``loss_fn`` for ``arch``'s
    reduced config with the MoE fields ``moe``, one compile per config."""
    cfg = _configs(arch, moe=dict(moe))[0]
    return jax.jit(jax.value_and_grad(functools.partial(JM.loss_fn, cfg=cfg), has_aux=True))


def make_batch(cfg, seed: int = 1, batch: int = BATCH, seq: int = SEQ) -> dict:
    """A seeded numpy batch for ``cfg``: tokens and targets (a few -1), or
    embeddings (and M-RoPE positions) and targets."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, -3:] = -1
    out = {"targets": targets}
    if cfg.input_mode == "tokens":
        out["tokens"] = toks[:, :-1]
    else:
        out["embeds"] = (rng.normal(size=(batch, seq, cfg.d_model)) * 0.02).astype(np.float32)
        if cfg.input_mode == "embeds_mrope":
            pos = np.arange(seq, dtype=np.int32)
            out["positions"] = np.broadcast_to(
                np.stack([pos, pos // 2, pos])[:, None], (3, batch, seq)).copy()
    return out


def port_grads(params, batch, cfg):
    """-> (loss, metrics, gradient tree) of the port's ``loss_fn``."""
    loss, metrics, grads = loss_and_grads(params, batch, cfg)
    return loss, metrics, unflatten(params, grads)


def run_both(arch: str, moe: dict | None = None, seed: int = 1, **port_fields):
    """Reference and port loss, metrics and gradients for one batch;
    ``port_fields`` change the port's config only (remat)."""
    moe = moe or {}
    jcfg, tcfg = _configs(arch, moe=moe)
    tcfg = dataclasses.replace(tcfg, **port_fields)
    _, host = _reference_params(arch)
    batch = make_batch(jcfg, seed)
    (jloss, jmetrics), jgrads = _reference_grad(arch, tuple(sorted(moe.items())))(
        jax.tree.map(jnp.asarray, host), {k: jnp.asarray(v) for k, v in batch.items()})
    params = train_state_from_numpy(host, "cpu")
    tloss, tmetrics, tgrads = port_grads(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         tcfg)
    return (jloss, jmetrics, jgrads), (tloss, tmetrics, tgrads)


def assert_close(got, want, what: str) -> None:
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= bound, f"{what}: max |port - reference| = {err:.3g} > {bound:.3g}"


def assert_matches(ref, port) -> None:
    (jloss, jmetrics, jgrads), (tloss, tmetrics, tgrads) = ref, port
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        assert_close(tmetrics[k].numpy(), jmetrics[k], k)
    assert_close(tloss.numpy(), jloss, "loss")
    jflat, tflat = jax.tree_util.tree_flatten_with_path(jgrads)[0], flatten_with_path(tgrads)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, want), (_, got) in zip(jflat, tflat):
        assert_close(got.numpy(), want, f"grad {path}")


# --- train steps -------------------------------------------------------------

N_STEPS = 3
OPT = dict(lr=1e-3, warmup=2, total=10)


@functools.cache
def _reference_step(arch: str, opt: str, hp: JT.TrainHparams, opt_kw: tuple = ()):
    jcfg = _configs(arch)[0]
    optimizer = JO.make_optimizer(opt, **OPT, **dict(opt_kw))
    return optimizer, jax.jit(JT.make_train_step(jcfg, optimizer, hp))


def assert_tree_close(got, want, what: str, flipped: dict | None = None) -> None:
    """Every leaf within TOL; with int8 compression (``flipped`` given)
    the exemptions of ``assert_int8_close``."""
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    if flipped is not None:
        for (_, w), (key, g) in zip(jflat, tflat):
            if key.startswith("['comp_err']"):
                note_int8_flips(g.float().numpy(), np.asarray(w, np.float32), key, flipped)
    for (_, w), (key, g) in zip(jflat, tflat):
        g, w = g.float().numpy(), np.asarray(w, dtype=np.float32)
        if flipped is None:
            assert_close(g, w, f"{what}{key}")
        else:
            assert_int8_close(g, w, f"{what}{key}", key, flipped)


def note_int8_flips(got, want, key: str, flipped: dict) -> None:
    """int8 compression rounds each element to a level of its leaf's
    quantum ``max|g| / 127``.  Where the two packages' gradients differ in
    their last bits across a rounding boundary, that element's level
    differs by one: its residual differs by one quantum and its
    transmitted gradient by minus one (and Adam's first steps, near
    ``lr * sign(g)``, may then move it by up to ``lr`` more or less).  A
    residual is at most half a quantum, so a quantum is at least twice the
    largest residual: an element whose residuals differ by more than half
    the largest is such a flip (others differ in the last bits).  Checks
    that flips are no more than 0.1 % of the leaf, each within one quantum,
    the rest within TOL, and records them under the parameter's path."""
    d = np.abs(got.astype(np.float64) - want)
    top = float(np.abs(want).max(initial=0.0))
    off = d > top / 2
    assert off.sum() <= max(1, want.size // 1000), f"{key}: {off.sum()} of {want.size} differ"
    assert float(d.max(initial=0.0)) <= 2 * top * (1 + 1e-3) + TOL, key
    assert_close(np.where(off, want, got), want, key)
    path = key.removeprefix("['comp_err']")
    flipped[path] = flipped.get(path, np.zeros(want.shape, bool)) | off


#: the trees that mirror the parameters, by the prefix of their paths
MIRRORS = ("['params']", "['opt']['m']", "['opt']['v']", "['opt']['master']")


def assert_int8_close(got, want, what: str, key: str, flipped: dict) -> None:
    """TOL, except at the elements whose int8 level differed at some step
    (``note_int8_flips``, which also checked the residual): there the
    parameter, its master copy and its moments within what the steps'
    updates can move them apart (N_STEPS x lr x 10)."""
    if key.startswith("['comp_err']"):
        return
    path = next((key.removeprefix(p) for p in MIRRORS if key.startswith(p)), None)
    mask = flipped.get(path)
    if mask is None or not mask.any():
        assert_close(got, want, what)
        return
    assert_close(np.where(mask, want, got), want, what)
    assert np.abs(got - want)[mask].max() <= N_STEPS * OPT["lr"] * 10, what


def run_steps(arch: str, opt: str, batch: int = 4, opt_kw: dict | None = None, **hp):
    hp_j, hp_t = JT.TrainHparams(**hp), TT.TrainHparams(**hp)
    opt_kw = opt_kw or {}
    optimizer, jstep = _reference_step(arch, opt, hp_j, tuple(sorted(opt_kw.items())))
    _, tcfg = _configs(arch)
    _, host = _reference_params(arch)
    jstate = JT.make_train_state(jax.tree.map(jnp.asarray, host), optimizer, hp_j)
    tstate = TT.make_train_state(train_state_from_numpy(host, "cpu"),
                                 TO.make_optimizer(opt, **OPT, **opt_kw), hp_t)
    want_tree = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype)) for p, x in want_tree] == [
        (p, tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in flatten_with_path(tstate)]
    tstep = TT.make_train_step(tcfg, TO.make_optimizer(opt, **OPT, **opt_kw), hp_t)
    flipped = {} if hp.get("compression") == "int8" else None
    for s in range(N_STEPS):
        b = make_batch(tcfg, seed=10 + s, batch=batch)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert_close(tm[k].numpy(), jm[k], f"step {s} {k}")
        assert int(tstate["step"]) == int(jstate["step"]) == s + 1
        assert_tree_close(tstate, jstate, f"step {s} ", flipped)
    return jm, tm


#: the train steps' hyperparameters: accumulation, each compression, an
#: active clip (0.05 of a gradient norm near 0.4), alone and together
HPARAMS = [dict(), dict(grad_accum=2), dict(compression="int8"), dict(compression="topk"),
           dict(grad_accum=2, compression="int8", clip_norm=0.05), dict(clip_norm=0.05)]
HPARAM_IDS = ["plain", "accum2", "int8", "topk", "accum2-int8-clip", "clip"]
