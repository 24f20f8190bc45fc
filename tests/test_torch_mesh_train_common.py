"""Rank functions of the meshed training tests (this module holds no test
of its own): ``tests/test_torch_mesh_grads.py`` and
``tests/test_torch_mesh_train.py`` spawn them through
``test_torch_mesh_common.spawn`` on a (2, 2) ``("data", "model")`` mesh of
four gloo ranks.  Ranks import torch, numpy and the port, never JAX.

Rank ``r`` sits at data ``r // 2``, model ``r % 2``.  Each rank gets the
full reference arrays and cuts its own blocks (``rules.params_local``,
``train_step.shard_batch``), as the reference's in-shardings hand each
device its block.
"""
import numpy as np
import torch

#: the MoE gradient cases: router, capacity factor, (B, S), fsdp, layout
GRAD_CASES = [
    (router, 8.0, bs, fsdp, lay)
    for router in ("hash", "topk")
    for bs in ((4, 16), (4, 1))
    for fsdp in (False, True)
    for lay in ("ep", "tp")
] + [("topk", 0.5, (4, 16), fsdp, lay) for fsdp in (False, True) for lay in ("ep", "tp")]


def grad_case_name(router, cf, bs, fsdp, lay) -> str:
    return f"{router}/{cf}/{bs[0]}x{bs[1]}/{'fsdp' if fsdp else 'nofsdp'}/{lay}"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def moe_grad_rank(rank, world, arrays):
    """Per case: this rank's gradients of ``sum(y * R) + aux`` through the
    meshed ``apply_moe`` (the rank backpropagates its data shard's part of
    the sum, and the aux loss, replicated on every rank): its block of
    each expert weight, the router's and its data
    shard of ``x`` (a leaf replicated over ``data`` summed over it, as the
    train step sums it).  Also whether the collectives without a gradient rule
    refuse a tensor that requires one."""
    from test_torch_mesh_common import moe_config

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import moe
    from repro_torch.sharding import rules

    mesh = make_local_mesh(2, 2, device_type="cpu")
    data = rules.coordinate(mesh)["data"]
    full = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith("p/")}
    out = {}
    for case in GRAD_CASES:
        name = grad_case_name(*case)
        router, cf, (B, S), fsdp, lay = case
        cfg = moe_config(router, cf)
        rows = slice(data * B // 2, (data + 1) * B // 2)
        x = _t(arrays[f"{B}x{S}/x"][rows]).requires_grad_()
        tok = _t(arrays[f"{B}x{S}/tok"][rows])
        R = _t(arrays[f"{B}x{S}/R"][rows])
        with rules.mesh_context(mesh, fsdp=fsdp, expert_layout=lay):
            p = {k: _t(v).requires_grad_() for k, v in rules.params_local(full).items()}
            y, aux = moe.apply_moe(p, x, tok, 3, cfg)
            share = (y * R).sum()  # this data shard's part of sum(y * R)
            names = sorted(p)
            try:
                grads = torch.autograd.grad(share + aux, [x] + [p[k] for k in names],
                                            allow_unused=True)
            except RuntimeError as e:  # a collective cut the graph: no backward at all
                out[name] = {"error": str(e)}
                continue
            total = rules.all_reduce(share.detach().clone(), "data") + aux.detach()
            res = {"x": None if grads[0] is None else grads[0].numpy(), "loss": float(total)}
            for k, g in zip(names, grads[1:]):
                if g is not None and "data" not in rules.param_spec(k, full[k].shape):
                    g = rules.all_reduce(g.clone(), "data")  # a leaf replicated over data
                res[k] = None if g is None else g.numpy()
        out[name] = res
    with rules.mesh_context(mesh):
        t = torch.ones(4, requires_grad=True) * 2.0
        refused = {}
        for what, fn in (("all_reduce", lambda: rules.all_reduce(t, "model")),
                         ("all_gather", lambda: rules.all_gather(t, "model", 0)),
                         ("reduce_scatter", lambda: rules.reduce_scatter(t, "model", 0))):
            try:
                fn()
                refused[what] = False
            except RuntimeError:
                refused[what] = True
            except Exception as e:  # noqa: BLE001 - recorded for the test to show
                refused[what] = repr(e)
        with torch.no_grad():
            refused["no_grad_runs"] = float(rules.all_reduce(t.clone(), "model").sum())
    out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# the meshed loss, gradients and train step
# ---------------------------------------------------------------------------

#: the loss/gradient cases: name, arch, expert layout, config overrides
#: (the four attention modes on the (2, 2) mesh: stablelm's 4 KV heads
#: split "head"; one KV head of 4 queries "rhead"; 3 heads of 16 split
#: mid-head "seq", and with a window "local")
LOSS_CASES = [
    ("qwen3/ep", "qwen3-moe-235b-a22b", "ep", {}),
    ("qwen3/tp", "qwen3-moe-235b-a22b", "tp", {"router": "hash", "remat": "full"}),
    ("deepseek-v3/ep", "deepseek-v3-671b", "ep", {}),
    ("stablelm-3b", "stablelm-3b", "ep", {}),
    ("mamba2-1.3b", "mamba2-1.3b", "ep", {}),
    ("rhead", "stablelm-3b", "ep", {"num_heads": 4, "num_kv_heads": 1}),
    ("seq", "stablelm-3b", "ep", {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16}),
    ("local", "stablelm-3b", "ep", {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16,
                                    "window": 8}),
]

#: the train-step cases: name, loss case, optimizer, its keywords, hparams
TRAIN_CASES = [
    ("adamw-master-clip", "stablelm-3b", "adamw", {"master_weights": True},
     {"clip_norm": 1e-3}),
    ("adafactor", "qwen3/ep", "adafactor", {}, {}),
    ("adamw-accum2", "deepseek-v3/ep", "adamw", {"master_weights": True}, {"grad_accum": 2}),
]

BATCH = (4, 16)


def case_config(configs, arch: str, overrides: dict):
    """``arch`` reduced, with ``overrides`` (``router`` goes to the MoE
    config) and an MoE capacity factor of 8: the same in both packages
    (``configs`` is ``repro.configs`` or ``repro_torch.configs``)."""
    import dataclasses

    cfg = configs.reduced_config(arch)
    over = dict(overrides)
    router = over.pop("router", None)
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
        if router:
            moe = dataclasses.replace(moe, router=router)
        cfg = dataclasses.replace(cfg, moe=moe)
    return dataclasses.replace(cfg, **over)


def _tree(like, arrays, prefix):
    """The port's tree shaped like ``like`` with leaves from ``arrays``
    under ``prefix + keystr path``."""
    from repro_torch.tree import flatten_with_path, unflatten

    return unflatten(like, [arrays[prefix + path] for path, _ in flatten_with_path(like)])


def _blocks(tree, prefix, out):
    from repro_torch.tree import flatten_with_path

    for path, leaf in flatten_with_path(tree):
        out[prefix + path] = leaf.detach().numpy().copy()


def train_rank(rank, world, arrays):
    """Per loss case: the loss and this rank's gradient blocks of the
    meshed ``loss_fn`` (fsdp on; leaves replicated over ``data`` summed
    over it) and the attention mode it ran; per train case: this rank's
    parameter and optimizer blocks after two meshed ZeRO-1 steps."""
    from repro_torch import configs
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention
    from repro_torch.models.layers.common import MetaGenerator
    from repro_torch.sharding import rules
    from repro_torch.training import train_step as T
    from repro_torch.training.optimizer import _spec_leaves, make_optimizer
    from repro_torch.tree import leaves, unflatten

    mesh = make_local_mesh(2, 2, device_type="cpu")
    out = {}
    for name, arch, lay, over in LOSS_CASES:
        cfg = case_config(configs, arch, over)
        like = M.init_train_params(MetaGenerator(), cfg)
        full = _tree(like, arrays, f"{name}/params")
        batch = {k: arrays[f"{name}/batch/{k}"] for k in ("tokens", "targets")}
        with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
            params = train_state_from_numpy({"params": full}, "cpu")["params"]
            params = rules.params_local(params)
            local = T.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()})
            loss, _, grads = T.loss_and_grads(params, local, cfg)
            specs = rules.params_pspecs(like)
            summed = [g if "data" in s else rules.all_reduce(g.clone(), "data")
                      for g, s in zip(grads, _spec_leaves(specs))]
            _blocks(unflatten(like, summed), f"{name}/grads", out)
            out[f"{name}/loss"] = float(loss)
            out[f"{name}/mode"] = (None if cfg.attention == "mla" or cfg.num_heads == 0 else
                                   attention._mode(cfg, BATCH[1]))
    for name, case, opt_name, kw, hp_kw in TRAIN_CASES:
        _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
        cfg = case_config(configs, arch, over)
        like = M.init_train_params(MetaGenerator(), cfg)
        opt = make_optimizer(opt_name, lr=1e-2, warmup=0, total=10, **kw)
        hp = T.TrainHparams(**hp_kw)
        state0 = T.make_train_state(like, opt, hp)  # the whole state's tree, on meta
        tree = {"params": _tree(like, arrays, f"{case}/params"),
                "opt": _tree(state0["opt"], arrays, f"{name}/opt0"),
                "step": np.zeros((), np.int32)}
        with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
            state = train_state_from_numpy(tree, "cpu", local=True)
            # the same blocks from the full parameters through make_train_state
            made = T.make_train_state(train_state_from_numpy(tree["params"], "cpu"), opt, hp)
            out[f"{name}/made_err"] = max(
                float((a - b).abs().max()) for k in ("params", "opt")
                for a, b in zip(leaves(made[k]), leaves(state[k]), strict=True))
            step = T.make_train_step(cfg, opt, hp)
            for i in range(2):
                batch = {k: torch.from_numpy(arrays[f"{name}/batch{i}/{k}"])
                         for k in ("tokens", "targets")}
                state, metrics = step(state, T.shard_batch(batch, hp.grad_accum))
                out[f"{name}/loss{i}"] = float(metrics["loss"])
                out[f"{name}/grad_norm{i}"] = float(metrics["grad_norm"])
            _blocks(state["params"], f"{name}/state/params", out)
            _blocks(state["opt"], f"{name}/state/opt", out)
    return out


#: the meshed serving cases: arch (and the attention mode or mixer its
#: reduced config takes on the (2, 2) mesh)
SERVE_ARCHS = ("stablelm-3b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "mamba2-1.3b",
               "recurrentgemma-9b")
SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 8, 3, 16


def serve_rank(rank, world, arrays):
    """Per arch, from the reference's parameters and prompts: this rank's
    rows and vocabulary block of the meshed prefill and decode logits (fsdp
    on, its blocks of the parameters, its data shard of the prompts, its
    block of the cache's slots), of the unmeshed port's, and the block's
    first column and width."""
    from repro_torch import configs
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import MetaGenerator, vocab_block
    from repro_torch.sharding import rules

    mesh = make_local_mesh(2, 2, device_type="cpu")
    data = rules.coordinate(mesh)["data"]
    out = {}
    for arch in SERVE_ARCHS:
        cfg = case_config(configs, arch, {})
        host = _tree(M.init_train_params(MetaGenerator(), cfg), arrays, f"serve/{arch}/params")
        toks = torch.from_numpy(arrays[f"serve/{arch}/tokens"])
        rows = slice(data * 2, data * 2 + 2)

        def run(p, tokens):
            cache, logits = M.prefill(p, {"tokens": tokens[:, :SERVE_PROMPT]}, cfg, SERVE_MAX_LEN)
            got = [logits]
            for i in range(SERVE_STEPS):
                cache, logits = M.decode_step(
                    p, cache, {"tokens": tokens[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1]}, cfg)
                got.append(logits)
            return torch.stack(got)

        with torch.no_grad():
            want = run(params_from_numpy(host, cfg, "cpu"), toks)[:, rows]
            with rules.mesh_context(mesh, fsdp=True, expert_layout="ep"):
                lo, n, _ = vocab_block(cfg)
                got = run(params_from_numpy(host, cfg, "cpu", local=True), toks[rows])
        out[arch] = (got.numpy(), want[..., lo:lo + n].numpy(), (lo, n))
    return out


def one_rank_steps(rank, world):
    """Three AdamW steps (master weights) of reduced Qwen3-MoE in bfloat16
    with the hash router and full remat, unmeshed and then under a one-rank
    (1, 1) mesh with fsdp, where every collective is over an axis of one
    rank and ZeRO-1 cuts nothing: -> each run's losses and grad norms, and
    the checks of the context rules: a state and a step with int8
    compression are made under the mesh (the state with a residual block
    for every leaf), and a step run under another mesh context than it was
    made in raises."""
    import contextlib
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step
    from repro_torch.tree import leaves

    base = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(base, remat="full", dtype="bfloat16", param_dtype="bfloat16",
                              moe=dataclasses.replace(base.moe, router="hash"))
    rng = np.random.default_rng(3)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))) for _ in range(3)]
    batches = [{"tokens": t[:, :-1].contiguous(), "targets": t[:, 1:].contiguous()} for t in toks]
    mesh = make_local_mesh(1, 1, device_type="cpu")
    out = {}
    for meshed in (False, True):
        ctx = rules.mesh_context(mesh, fsdp=True, expert_layout="ep")
        with ctx if meshed else contextlib.nullcontext():
            opt = make_optimizer("adamw", lr=1e-3, warmup=0, total=3, master_weights=True)
            params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
            state = make_train_state(params, opt)
            step = make_train_step(cfg, opt)
            runs = []
            for b in batches:
                state, metrics = step(state, b)
                runs.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        out["meshed" if meshed else "unmeshed"] = runs

    def refused(fn, kind) -> bool:
        try:
            fn()
        except kind:
            return True
        return False

    int8 = TrainHparams(compression="int8")
    params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
    unmeshed_step = make_train_step(cfg, opt)
    with rules.mesh_context(mesh, fsdp=True, expert_layout="ep"):
        made = make_train_state(params, opt, int8)
        out["refused"] = {
            "state with compression made": [tuple(e.shape) for e in leaves(made["comp_err"])]
            == [tuple(p.shape) for p in leaves(made["params"])],
            "step with compression made": callable(make_train_step(cfg, opt, int8)),
            "step of another context": refused(
                lambda: unmeshed_step(state, batches[0]), RuntimeError),
        }
    return out


# ---------------------------------------------------------------------------
# gradient compression under the mesh
# ---------------------------------------------------------------------------

#: the distributed select's layouts per world size: (data, model) mesh
#: shape and the axes that cut the leaf (the others hold replicated copies)
SELECT_LAYOUTS = {
    1: [((1, 1), ("model",))],
    2: [((1, 2), ("model",)), ((2, 1), ("model",))],
    4: [((2, 2), ("model",)), ((2, 2), ("data", "model"))],
}


def select_blocks(x: np.ndarray, n_blocks: int, uneven: bool) -> list:
    """A flat leaf (of at least 4 elements when ``uneven``) cut into
    ``n_blocks`` contiguous blocks: even, or at uneven points (the first
    block a single element, the third too when there are four)."""
    if not uneven:
        return np.array_split(x, n_blocks)
    return np.split(x, [1, x.size // 2, x.size // 2 + 1][:n_blocks - 1])


def select_rank(rank, world, cases):
    """Per layout of ``SELECT_LAYOUTS[world]`` and per case ``name -> (x,
    k, uneven)``: the bit pattern of ``compression.kth_magnitude`` of this
    rank's block of ``x`` over the cutting axes (every rank of a
    replicated axis passes the same block)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import rules
    from repro_torch.training.compression import kth_magnitude

    out = {}
    for shape, axes in SELECT_LAYOUTS[world]:
        mesh = make_local_mesh(*shape, device_type="cpu")
        coord = rules.coordinate(mesh)
        sizes = dict(zip(("data", "model"), shape))
        index, n_blocks = 0, 1
        for a in axes:
            index, n_blocks = index * sizes[a] + coord[a], n_blocks * sizes[a]
        with rules.mesh_context(mesh):
            for name, (x, k, uneven) in cases.items():
                block = torch.from_numpy(select_blocks(x, n_blocks, uneven)[index].copy())
                got = kth_magnitude(block, int(k), axes)
                out[(shape, axes, name)] = int(got.view(torch.int32))
    return out


#: the meshed compression cases: name, loss case (``LOSS_CASES``), kind;
#: AdamW with master weights
COMP_CASES = [(f"{kind}/{case}", case, kind) for kind in ("int8", "topk")
              for case in ("qwen3/tp", "stablelm-3b")]
COMP_STEPS = 2
COMP_LR = 1e-2


def compression_rank(rank, world, arrays):
    """Per case of ``COMP_CASES``: this rank's parameter, optimizer and
    residual blocks after each of ``COMP_STEPS`` meshed ZeRO-1 steps with
    the compression, the losses and grad norms, the float32 threshold of
    every leaf at every ``topk`` step (the select's, recorded as the step
    calls it) and whether ``make_train_state`` cuts the same blocks."""
    from repro_torch import configs
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import MetaGenerator
    from repro_torch.sharding import rules
    from repro_torch.training import compression as C
    from repro_torch.training import train_step as T
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.tree import leaves, tree_map

    mesh = make_local_mesh(2, 2, device_type="cpu")
    select = C.kth_magnitude
    seen: list = []

    def recorded(gf, k, axes=()):
        t = select(gf, k, axes)
        seen.append(float(t))
        return t

    C.kth_magnitude = recorded
    out = {}
    try:
        for name, case, kind in COMP_CASES:
            _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
            cfg = case_config(configs, arch, over)
            like = M.init_train_params(MetaGenerator(), cfg)
            opt = make_optimizer("adamw", lr=COMP_LR, warmup=0, total=10, master_weights=True)
            hp = T.TrainHparams(compression=kind)
            state0 = T.make_train_state(like, opt, hp)
            params = _tree(like, arrays, f"{case}/params")
            tree = {"params": params, "opt": _tree(state0["opt"], arrays, f"{name}/opt0"),
                    "step": np.zeros((), np.int32),
                    "comp_err": tree_map(lambda a: np.zeros(a.shape, np.float32), params)}
            with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
                state = train_state_from_numpy(tree, "cpu", local=True)
                made = T.make_train_state(train_state_from_numpy(params, "cpu"), opt, hp)
                out[f"{name}/made_err"] = max(
                    float((a - b).abs().max()) for k in ("params", "opt", "comp_err")
                    for a, b in zip(leaves(made[k]), leaves(state[k]), strict=True))
                step = T.make_train_step(cfg, opt, hp)
                for i in range(COMP_STEPS):
                    batch = {k: torch.from_numpy(arrays[f"{name}/batch{i}/{k}"])
                             for k in ("tokens", "targets")}
                    seen.clear()
                    state, metrics = step(state, T.shard_batch(batch))
                    out[f"{name}/loss{i}"] = float(metrics["loss"])
                    out[f"{name}/grad_norm{i}"] = float(metrics["grad_norm"])
                    out[f"{name}/thresh{i}"] = list(seen)
                    for part in ("params", "opt", "comp_err"):
                        _blocks(state[part], f"{name}/state{i}/{part}", out)
    finally:
        C.kth_magnitude = select
    return out


def one_rank_compression_steps(rank, world):
    """Three AdamW steps (master weights) of reduced Qwen3-MoE in bfloat16
    with the hash router and full remat, for each compression, unmeshed
    and then under a one-rank (1, 1) mesh with fsdp: -> each run's losses,
    grad norms and final residuals and parameters."""
    import contextlib
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step
    from repro_torch.tree import flatten_with_path

    base = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(base, remat="full", dtype="bfloat16", param_dtype="bfloat16",
                              moe=dataclasses.replace(base.moe, router="hash"))
    rng = np.random.default_rng(3)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))) for _ in range(3)]
    batches = [{"tokens": t[:, :-1].contiguous(), "targets": t[:, 1:].contiguous()} for t in toks]
    mesh = make_local_mesh(1, 1, device_type="cpu")
    out = {}
    for kind in ("int8", "topk"):
        hp = TrainHparams(compression=kind)
        for meshed in (False, True):
            ctx = rules.mesh_context(mesh, fsdp=True, expert_layout="ep")
            with ctx if meshed else contextlib.nullcontext():
                opt = make_optimizer("adamw", lr=1e-3, warmup=0, total=3, master_weights=True)
                params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
                state = make_train_state(params, opt, hp)
                step = make_train_step(cfg, opt, hp)
                runs = []
                for b in batches:
                    state, metrics = step(state, b)
                    runs.append((float(metrics["loss"]), float(metrics["grad_norm"])))
            out[kind, meshed] = {
                "runs": runs,
                "state": {f"{part}{path}": leaf.float().numpy().copy()
                          for part in ("params", "comp_err")
                          for path, leaf in flatten_with_path(state[part])}}
    return out
