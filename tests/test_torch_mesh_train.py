"""The port's meshed training — ``model.loss_fn`` and its gradients, and
the ZeRO-1 train step — under a (2, 2) ``("data", "model")`` mesh of 4
gloo ranks with fsdp on, against the JAX package's meshed runs (a
subprocess with 4 CPU devices, a mesh of Auto axes): ``jax.jit`` of
``loss_fn`` and of its ``jax.grad`` with the parameters and the batch laid
out by ``params_pspecs``/``batch_pspecs``, and two steps of
``jax.jit(step, in_shardings=state_sh, out_shardings=(state_sh, None))``
with the optimizer state's specs from ``zero1_pspecs``.  The counterpart
of ``tests/test_mesh_numerics.py``.

Loss cases: the five of ``test_mesh_numerics.py`` (reduced Qwen3-MoE
``ep`` and ``tp`` — the latter with the hash router and full remat —,
DeepSeek-V3 ``ep`` with MLA, the sigmoid router, a shared expert and the
MTP loss, StableLM-3B, Mamba2-1.3B) and three StableLM variants that take
the other attention modes (``rhead``, ``seq``, ``local``; StableLM and
Qwen3 take ``head``).  The loss must lie within ``LOSS_TOL`` on every
rank, and every rank's gradient block within ``GRAD_TOL`` of max |the
reference's gradient| (float32).  Train cases: AdamW with master weights
and a clip that bites, Adafactor (its row and column statistics reduced
across the blocks), and AdamW with ``grad_accum`` 2; every rank's
parameter and optimizer blocks (ZeRO-1: each holds only its block of the
optimizer state) after two steps: the moments within ``GRAD_TOL`` of max
|reference|, the parameters and master weights within ``GRAD_TOL`` of
max(1, max |reference|), the convention of ``test_torch_train_step.py``
(Adam moves each element by about ``lr`` whatever its gradient's size, so
an element whose gradient is a few ulps from zero carries that noise into
the parameter at the scale of ``lr``, not of the parameter).

Serving under the same mesh (fsdp on): the meshed prefill and three
decode steps of five reduced models (GQA heads, the MoE layer, MLA,
Mamba-2 SSD, RG-LRU with a windowed attention), from the reference's
parameters and prompts, give each rank's rows and vocabulary block of the
reference's meshed logits (``jax.jit`` of ``prefill``/``decode_step`` on
parameters and prompts laid out by the rules) and of the unmeshed port's
within ``GRAD_TOL`` of max |logits| (the cache's slots cut over
``model``, flash-decoding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_common import reference, spawn  # noqa: E402
from test_torch_mesh_train_common import (  # noqa: E402
    LOSS_CASES,
    SERVE_ARCHS,
    TRAIN_CASES,
    one_rank_steps,
    serve_rank,
    train_rank,
)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

_REFERENCE = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

sys.path.insert(0, %r)
from test_torch_mesh_train_common import (BATCH, LOSS_CASES, SERVE_ARCHS, SERVE_MAX_LEN,
                                          SERVE_PROMPT, SERVE_STEPS, TRAIN_CASES, case_config)

from repro import configs
from repro.models import model as M
from repro.sharding import rules
from repro.training.optimizer import make_optimizer, zero1_pspecs
from repro.training.train_step import TrainHparams, make_train_state, make_train_step

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
PART = sys.argv[2]  # "train" (the loss and train cases) or "serve", run side by side


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def shardings(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P))


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, S = BATCH
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


params_of = {}
for name, arch, lay, over in LOSS_CASES if PART == "train" else ():
    cfg = case_config(configs, arch, over)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    params_of[name] = params
    batch = make_batch(cfg, 0)
    put(f"{name}/params", params)
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
        psh = shardings(rules.params_pspecs(params))
        bsh = shardings(rules.batch_pspecs(batch))
        pm, bm = jax.device_put(params, psh), jax.device_put(batch, bsh)
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(p, b, cfg)[0]))(pm, bm)
    out[f"{name}/loss"] = np.asarray(loss)
    put(f"{name}/grads", jax.device_get(grads))

for name, case, opt_name, kw, hp_kw in TRAIN_CASES if PART == "train" else ():
    _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
    cfg = case_config(configs, arch, over)
    opt = make_optimizer(opt_name, lr=1e-2, warmup=0, total=10, **kw)
    hp = TrainHparams(**hp_kw)
    state = make_train_state(params_of[case], opt, hp)
    put(f"{name}/opt0", state["opt"])
    with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
        pspecs = rules.params_pspecs(state["params"])
        specs = {"params": pspecs, "opt": zero1_pspecs(state["params"], pspecs, state["opt"]),
                 "step": P()}
        sh = shardings(specs)
        step = jax.jit(make_train_step(cfg, opt, hp), in_shardings=(sh, None),
                       out_shardings=(sh, None))
        state = jax.device_put(state, sh)
        for i in range(2):
            batch = make_batch(cfg, 10 + i)
            for k, v in batch.items():
                out[f"{name}/batch{i}/{k}"] = v
            state, metrics = step(state, batch)
            out[f"{name}/loss{i}"] = np.asarray(metrics["loss"])
            out[f"{name}/grad_norm{i}"] = np.asarray(metrics["grad_norm"])
    put(f"{name}/state/params", jax.device_get(state["params"]))
    put(f"{name}/state/opt", jax.device_get(state["opt"]))

for arch in SERVE_ARCHS if PART == "serve" else ():
    cfg = case_config(configs, arch, {})
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    put(f"serve/{arch}/params", params)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH[0], SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)
    out[f"serve/{arch}/tokens"] = toks
    with rules.mesh_context(mesh, fsdp=True, expert_layout="ep"):
        pm = jax.device_put(params, shardings(rules.params_pspecs(params)))
        prefill = jax.jit(lambda p, b, cfg=cfg: M.prefill(p, b, cfg, SERVE_MAX_LEN))
        decode = jax.jit(lambda p, c, b, cfg=cfg: M.decode_step(p, c, b, cfg))

        def tokens(lo, hi):
            b = {"tokens": toks[:, lo:hi]}
            return jax.device_put(b, shardings(rules.batch_pspecs(b)))

        cache, logits = prefill(pm, tokens(0, SERVE_PROMPT))
        got = [np.asarray(logits)]
        for i in range(SERVE_STEPS):
            cache, logits = decode(pm, cache, tokens(SERVE_PROMPT + i, SERVE_PROMPT + i + 1))
            got.append(np.asarray(logits))
    out[f"serve/{arch}/logits"] = np.stack(got)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import os
    from concurrent.futures import ThreadPoolExecutor

    script = _REFERENCE % os.path.dirname(os.path.abspath(__file__))
    with ThreadPoolExecutor(2) as pool:
        parts = [pool.submit(reference, script, tmp_path_factory.mktemp(f"ref_mesh_{part}"), part)
                 for part in ("train", "serve")]
        return {k: v for f in parts for k, v in f.result().items()}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    arrays = {k: v for k, v in ref.items() if not k.startswith("serve/")
              and ("/params[" in k or "/batch" in k or "/opt0[" in k)}
    return spawn(train_rank, 4, tmp_path_factory.mktemp("mesh_train_ranks"), arrays)


def _specs(ref, name, kind):
    """keystr path -> the spec the rules give that reference leaf under the
    case's mesh context on a (2, 2) layout: the parameters' own, or (for
    the optimizer state) ``zero1_pspecs``'."""
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import MetaGenerator
    from repro_torch.sharding import rules
    from repro_torch.training import train_step as T
    from repro_torch.training.optimizer import _spec_leaves, make_optimizer, zero1_pspecs
    from repro_torch.tree import flatten_with_path
    from test_torch_mesh_train_common import case_config

    case = name
    opt = None
    for tname, tcase, opt_name, kw, hp_kw in TRAIN_CASES:
        if tname == name:
            case, opt = tcase, make_optimizer(opt_name, **kw)
    _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
    cfg = case_config(configs, arch, over)
    like = M.init_train_params(MetaGenerator(), cfg)
    opt_state = T.make_train_state(like, opt)["opt"] if kind == "opt" else None
    with rules.mesh_context(MeshLayout(("data", "model"), (2, 2)), fsdp=True, expert_layout=lay):
        pspecs = rules.params_pspecs(like)
        if kind == "opt":
            tree, specs = opt_state, zero1_pspecs(like, pspecs, opt_state)
        else:
            tree, specs = like, pspecs
    return dict(zip([p for p, _ in flatten_with_path(tree)], _spec_leaves(specs)))


def _weights_floor(path: str) -> float:
    """The scale floor of a train-state leaf: 1 for weights (parameters and
    master weights), none for moments."""
    return 1.0 if "['master']" in path or "['m']" not in path and "['v']" not in path and "['f']" not in path else 0.0


def _check_blocks(ref, ranks, ref_prefix, got_prefix, specs, floor=lambda path: 0.0):
    """Every rank's block of every leaf within ``GRAD_TOL`` of
    max(floor(path), max |reference leaf|)."""
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.sharding import rules

    layout = MeshLayout(("data", "model"), (2, 2))
    n = 0
    for path, spec in specs.items():
        full = ref[ref_prefix + path]
        scale = max(float(np.abs(full).max()), 1e-30, floor(path))
        for rank, r in enumerate(ranks):
            want = rules.local_slice(full, spec, layout, {"data": rank // 2, "model": rank % 2})
            got = r[got_prefix + path]
            assert got.shape == want.shape, (path, rank, got.shape, want.shape)
            err = float(np.abs(got - want).max())
            assert err <= GRAD_TOL * scale, (path, rank, err, scale)
            n += 1
    assert n > 0


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_meshed_loss_and_gradients_match_reference(case, ref, ranks):
    name = case[0]
    want = float(ref[f"{name}/loss"])
    for r in ranks:
        assert abs(r[f"{name}/loss"] - want) <= LOSS_TOL * max(1.0, abs(want))
    _check_blocks(ref, ranks, f"{name}/grads", f"{name}/grads", _specs(ref, name, "params"))


def test_every_attention_mode_is_exercised(ranks):
    modes = {ranks[0][f"{c[0]}/mode"] for c in LOSS_CASES}
    assert {"head", "rhead", "seq", "local"} <= modes, modes


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_meshed_zero1_steps_match_reference(case, ref, ranks):
    name = case[0]
    for i in range(2):
        for key in ("loss", "grad_norm"):
            want = float(ref[f"{name}/{key}{i}"])
            for r in ranks:
                assert abs(r[f"{name}/{key}{i}"] - want) <= GRAD_TOL * max(1.0, abs(want)), (key, i)
    # make_train_state cuts the full parameters into the blocks interop's local=True gives
    assert all(r[f"{name}/made_err"] == 0.0 for r in ranks)
    if name == "adamw-master-clip":  # the clip bites
        assert float(ref[f"{name}/grad_norm0"]) > case[4]["clip_norm"]
    _check_blocks(ref, ranks, f"{name}/state/params", f"{name}/state/params",
                  _specs(ref, name, "params"), _weights_floor)
    _check_blocks(ref, ranks, f"{name}/state/opt", f"{name}/state/opt", _specs(ref, name, "opt"),
                  _weights_floor)


@pytest.fixture(scope="module")
def served(ref, tmp_path_factory):
    arrays = {k: v for k, v in ref.items() if k.startswith("serve/") and not k.endswith("/logits")}
    return spawn(serve_rank, 4, tmp_path_factory.mktemp("mesh_serve_ranks"), arrays)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_prefill_and_decode_match_unmeshed(arch, served):
    for rank, r in enumerate(served):
        got, want, _ = r[arch]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (rank, err)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_prefill_and_decode_match_reference(arch, ref, served):
    """Each rank's rows and vocabulary block of the meshed logits against
    the reference's meshed prefill and decode."""
    full = ref[f"serve/{arch}/logits"]
    for rank, r in enumerate(served):
        got, _, (lo, n) = r[arch]
        rows = slice(rank // 2 * 2, rank // 2 * 2 + 2)
        want = full[:, rows, lo:lo + n]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * float(np.abs(full).max()), (rank, err)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    (r,) = spawn(one_rank_steps, 1, tmp_path_factory.mktemp("one_rank"))
    return r


def test_one_rank_mesh_steps_match_unmeshed(one_rank):
    """On a one-rank (1, 1) mesh the meshed step is the unmeshed one: the
    same losses bit for bit in bfloat16, and the grad norms within 1e-6
    (the norm sums its squares by the axes that cut each leaf's ZeRO-1
    block, in another order)."""
    r = one_rank
    assert [loss for loss, _ in r["meshed"]] == [loss for loss, _ in r["unmeshed"]]
    for (_, g0), (_, g1) in zip(r["unmeshed"], r["meshed"]):
        assert abs(g1 - g0) <= 1e-6 * abs(g0), (g0, g1)


def test_meshed_train_refusals(one_rank):
    """Under a mesh a state and a step with gradient compression are made
    (the state holds a residual block for every leaf; the meshed steps
    themselves are ``tests/test_torch_compression_mesh.py``'s), and a step
    made under another mesh context raises instead of training on the
    wrong layout."""
    assert one_rank["refused"] == {k: True for k in one_rank["refused"]}, one_rank["refused"]
    assert len(one_rank["refused"]) == 3
