"""Gradient compression under a mesh: the port's meshed train step
compresses each leaf's ZeRO-1 block of the summed gradient as the JAX
package's meshed ``jax.jit`` step compresses the whole summed gradient.

* The select (``compression.kth_magnitude``) with no cutting axis, and
  the distributed one over 1, 2 and 4 gloo ranks with the leaf cut over
  one axis and replicated over the other, or cut over both, equals
  ``jax.lax.top_k(|x|, k)[0][-1]`` bit for bit: ties at the threshold, an all-equal leaf, an all-zero leaf,
  ``-0.0``, subnormals, k = 1, k = numel, and blocks of uneven sizes.
* Two steps of the reference's meshed ``jax.jit`` step (a subprocess with
  4 CPU devices, Auto axes, the state laid out by ``params_pspecs`` and
  ``zero1_pspecs``, its residual as the moments are) with ``int8`` and
  with ``topk``, against the port's 4 gloo ranks on a (2, 2) mesh with
  fsdp: reduced Qwen3-MoE with the hash router (``tp``, full remat) and
  StableLM-3B, AdamW with master weights.  After each step every rank's
  parameter, optimizer and residual blocks lie within ``GRAD_TOL`` of
  max(floor, max |reference leaf|) (``tests/test_torch_mesh_train.py``'s
  convention; a residual's scale is its gradient's), apart from the
  elements whose compression decision flips between the packages, whose
  gradients differ in their last bits:
  ``int8``, an element whose level differs by one (its residual by one
  quantum; ``note_int8_flips`` of ``test_torch_train_common.py``);
  ``topk``, an element kept on one side only, whose ``|gf|`` must lie
  within ``NEAR`` relative of the port's threshold at that step.  Their
  count is reported and bounded by ``FLIP_SHARE`` of each leaf and by
  ``MOST_FLIPS`` a case (one ``int8`` flip in each case, no ``topk`` flip,
  on the tree that added this file); at a
  flipped element the parameter and its state may move apart by what the
  steps' updates allow (``COMP_STEPS x COMP_LR x 10``), and its residual
  at a later step carries the flip (within two quanta, or two
  thresholds).
* On a one-rank (1, 1) mesh the compressed steps equal the unmeshed ones
  bit for bit: the same losses and residuals and parameters, the grad
  norms within 1e-6 (their squares are summed by the axes that cut each
  block, in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_mesh_common import reference, spawn  # noqa: E402
from test_torch_mesh_train_common import (  # noqa: E402
    COMP_CASES,
    COMP_LR,
    COMP_STEPS,
    LOSS_CASES,
    SELECT_LAYOUTS,
    compression_rank,
    one_rank_compression_steps,
    select_rank,
)

GRAD_TOL = 1e-4
#: a topk flip's |gf| lies this close to the threshold, relatively
NEAR = 1e-5
#: the most flipped elements of one leaf at one step, as a share of it
FLIP_SHARE = 1e-3
#: the most flipped elements of one case, over its steps and leaves
MOST_FLIPS = 4


def _select_cases() -> dict:
    rng = np.random.default_rng(5)
    ties = (rng.integers(-6, 7, size=4096) / 8).astype(np.float32)
    normal = rng.normal(size=4099).astype(np.float32)
    zeros = np.where(rng.random(1024) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[::97] = rng.normal(size=zeros[::97].size).astype(np.float32)
    return {
        "ties": (ties, int(ties.size * 0.05), False),
        "ties-mid-run": (ties, 1000, True),
        "all-equal": (np.full(1024, -0.375, np.float32), 51, False),
        "all-zero": (np.zeros(1024, np.float32), 51, True),
        "neg-zero": (zeros, 51, False),
        "subnormal": ((rng.normal(size=2048) * 1e-39).astype(np.float32), 102, True),
        "k-1": (normal, 1, True),
        "k-numel": (normal, normal.size, False),
        "uneven": (normal, 204, True),
    }


@pytest.mark.parametrize("world", sorted(SELECT_LAYOUTS))
def test_distributed_select_matches_top_k(world, tmp_path):
    cases = _select_cases()
    want = {name: int(np.asarray(jax.lax.top_k(jax.numpy.abs(x), k)[0][-1]).view(np.int32))
            for name, (x, k, _) in cases.items()}
    assert want["all-zero"] == want["neg-zero"] == 0  # the threshold keeps everything
    results = spawn(select_rank, world, tmp_path, cases)
    n = 0
    for r in results:
        for (shape, axes, name), bits in r.items():
            assert bits == want[name], (shape, axes, name, bits, want[name])
            n += 1
    assert n == world * len(cases) * len(SELECT_LAYOUTS[world])


@pytest.mark.parametrize("name", sorted(_select_cases()))
def test_select_with_no_axes_is_top_k(name):
    """With no axis cutting the leaf ``kth_magnitude`` is ``torch.topk``'s
    k-th value (the unmeshed step's threshold), and the radix select over
    the whole leaf gives the same bits."""
    from repro_torch.training.compression import kth_magnitude, radix_kth_magnitude

    x, k, _ = _select_cases()[name]
    want = int(np.asarray(jax.lax.top_k(jax.numpy.abs(x), k)[0][-1]).view(np.int32))
    leaf = torch.from_numpy(x)
    assert int(kth_magnitude(leaf, k).view(torch.int32)) == want
    assert int(radix_kth_magnitude(leaf, k).view(torch.int32)) == want


_REFERENCE = r"""
import sys

import jax
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

sys.path.insert(0, %r)
from test_torch_mesh_train_common import (BATCH, COMP_CASES, COMP_LR, COMP_STEPS, LOSS_CASES,
                                          case_config)

from repro import configs
from repro.models import model as M
from repro.sharding import rules
from repro.training.optimizer import make_optimizer, zero1_pspecs
from repro.training.train_step import TrainHparams, make_train_state, make_train_step

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def shardings(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P))


params_of = {}
for name, case, kind in COMP_CASES:
    _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
    cfg = case_config(configs, arch, over)
    if case not in params_of:
        params_of[case] = M.init_params(jax.random.PRNGKey(0), cfg)
        put(f"{case}/params", params_of[case])
    opt = make_optimizer("adamw", lr=COMP_LR, warmup=0, total=10, master_weights=True)
    hp = TrainHparams(compression=kind)
    state = make_train_state(params_of[case], opt, hp)
    put(f"{name}/opt0", state["opt"])
    with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
        pspecs = rules.params_pspecs(state["params"])
        specs = {"params": pspecs, "opt": zero1_pspecs(state["params"], pspecs, state["opt"]),
                 "step": P(),
                 "comp_err": zero1_pspecs(state["params"], pspecs, {"m": state["comp_err"]})["m"]}
        sh = shardings(specs)
        step = jax.jit(make_train_step(cfg, opt, hp), in_shardings=(sh, None),
                       out_shardings=(sh, None))
        state = jax.device_put(state, sh)
        for i in range(COMP_STEPS):
            rng = np.random.default_rng(20 + i)
            B, S = BATCH
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                     "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
            for k, v in batch.items():
                out[f"{name}/batch{i}/{k}"] = v
            state, metrics = step(state, batch)
            out[f"{name}/loss{i}"] = np.asarray(metrics["loss"])
            out[f"{name}/grad_norm{i}"] = np.asarray(metrics["grad_norm"])
            for part in ("params", "opt", "comp_err"):
                put(f"{name}/state{i}/{part}", jax.device_get(state[part]))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import os

    script = _REFERENCE % os.path.dirname(os.path.abspath(__file__))
    return reference(script, tmp_path_factory.mktemp("ref_compression"))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    arrays = {k: v for k, v in ref.items() if "/state" not in k
              and ("/params[" in k or "/batch" in k or "/opt0[" in k)}
    return spawn(compression_rank, 4, tmp_path_factory.mktemp("compression_ranks"), arrays)


def _layouts(case):
    """-> (the param paths in flatten order, the (2, 2) layout, and path ->
    spec for the parameters, the optimizer state and the residual)."""
    from test_torch_mesh_train_common import case_config

    from repro_torch import configs
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import MetaGenerator
    from repro_torch.sharding import rules
    from repro_torch.training import train_step as T
    from repro_torch.training.optimizer import _spec_leaves, make_optimizer, zero1_pspecs
    from repro_torch.tree import flatten_with_path

    _, arch, lay, over = next(c for c in LOSS_CASES if c[0] == case)
    cfg = case_config(configs, arch, over)
    like = M.init_train_params(MetaGenerator(), cfg)
    opt_state = T.make_train_state(like, make_optimizer("adamw", master_weights=True))["opt"]
    layout = MeshLayout(("data", "model"), (2, 2))
    with rules.mesh_context(layout, fsdp=True, expert_layout=lay):
        pspecs = rules.params_pspecs(like)
        specs = {"params": pspecs, "opt": zero1_pspecs(like, pspecs, opt_state),
                 "comp_err": zero1_pspecs(like, pspecs, {"m": like})["m"]}
    trees = {"params": like, "opt": opt_state, "comp_err": like}
    out = {part: dict(zip([p for p, _ in flatten_with_path(trees[part])],
                          _spec_leaves(specs[part]))) for part in trees}
    return [p for p, _ in flatten_with_path(like)], layout, out


def _slices(spec, shape, layout, coord) -> tuple:
    """The index of the block that ``spec`` gives the rank at ``coord``."""
    from repro_torch.sharding import rules

    index = []
    for dim, entry in enumerate(spec):
        i, n = rules.block(entry, layout, coord)
        size = shape[dim] // n
        index.append(slice(i * size, (i + 1) * size))
    return tuple(index)


def _coords():
    return [{"data": rank // 2, "model": rank % 2} for rank in range(4)]


def _param_path(path: str) -> str:
    """An optimizer leaf's path -> its parameter's path."""
    for prefix in ("['m']", "['v']", "['master']"):
        if path.startswith(prefix):
            return path.removeprefix(prefix)
    raise AssertionError(path)


def _note_flips(kind, got, want, top, thresh, before, path) -> np.ndarray:
    """One rank's residual block against the reference's -> the mask of its
    flipped elements (checking the rest within ``GRAD_TOL`` and the flips
    as the module docstring says); ``before`` marks the elements flipped at
    an earlier step, whose residual carries that flip.  The tolerance is
    ``GRAD_TOL`` of the leaf's gradient scale: ``top`` for ``topk`` (the
    residual holds gradient elements), 254 ``top`` for ``int8`` (a
    residual is at most half a quantum, and the largest gradient element
    is 127 quanta)."""
    tol = GRAD_TOL * max(top, 1e-30) * (254 if kind == "int8" else 1)
    d = np.abs(got.astype(np.float64) - want)
    if kind == "int8":
        off = d > top / 2
        assert float(d.max(initial=0.0)) <= 2 * top * (1 + 1e-3) + tol, path
    else:
        off = d > tol
        one_side = (got == 0) != (want == 0)
        assert (one_side | before)[off].all(), (path, "a residual differs, both sides nonzero")
        mag = np.where(got == 0, np.abs(want), np.abs(got))
        near = np.abs(mag - thresh) <= NEAR * thresh
        assert (near | before)[off].all(), (path, "a kept element flips away from the threshold",
                                            thresh, mag[off & ~near & ~before][:4])
        assert float(np.where(before, d, 0.0).max(initial=0.0)) <= 2 * thresh * (1 + 1e-3) + tol
    assert off.sum() <= max(1, int(want.size * FLIP_SHARE)), (path, int(off.sum()), want.size)
    assert float(np.where(off | before, 0.0, d).max(initial=0.0)) <= tol, path
    return off


@pytest.mark.parametrize("case", COMP_CASES, ids=[c[0] for c in COMP_CASES])
def test_meshed_compressed_steps_match_reference(case, ref, ranks):
    name, loss_case, kind = case
    assert all(r[f"{name}/made_err"] == 0.0 for r in ranks)
    paths, layout, specs = _layouts(loss_case)
    coords = _coords()
    flipped = {p: np.zeros(ref[f"{name}/state0/comp_err{p}"].shape, bool) for p in paths}
    report = []
    for i in range(COMP_STEPS):
        for key in ("loss", "grad_norm"):
            want = float(ref[f"{name}/{key}{i}"])
            for r in ranks:
                assert abs(r[f"{name}/{key}{i}"] - want) <= GRAD_TOL * max(1.0, abs(want)), \
                    (key, i, r[f"{name}/{key}{i}"], want)
        threshes = ranks[0][f"{name}/thresh{i}"]
        assert all(r[f"{name}/thresh{i}"] == threshes for r in ranks)  # one global threshold
        assert len(threshes) == (len(paths) if kind == "topk" else 0)
        for j, path in enumerate(paths):
            full = ref[f"{name}/state{i}/comp_err{path}"]
            top = float(np.abs(full).max(initial=0.0))
            new = np.zeros(full.shape, bool)
            for r, coord in zip(ranks, coords):
                at = _slices(specs["comp_err"][path], full.shape, layout, coord)
                got = r[f"{name}/state{i}/comp_err{path}"]
                assert got.shape == full[at].shape, (path, got.shape, full[at].shape)
                new[at] |= _note_flips(kind, got, full[at], top,
                                       threshes[j] if kind == "topk" else None,
                                       flipped[path][at], path)
            report.append((i, path, int((new & ~flipped[path]).sum())))
            flipped[path] |= new
        for part in ("params", "opt"):
            for path, spec in specs[part].items():
                full = ref[f"{name}/state{i}/{part}{path}"]
                mask = flipped[path if part == "params" else _param_path(path)]
                floor = 0.0 if path.startswith(("['m']", "['v']")) else 1.0
                scale = max(float(np.abs(full).max(initial=0.0)), 1e-30, floor)
                for r, coord in zip(ranks, coords):
                    at = _slices(spec, full.shape, layout, coord)
                    got, want, off = r[f"{name}/state{i}/{part}{path}"], full[at], mask[at]
                    assert got.shape == want.shape, (part, path, got.shape, want.shape)
                    d = np.abs(got.astype(np.float64) - want)
                    assert float(np.where(off, 0.0, d).max(initial=0.0)) <= GRAD_TOL * scale, \
                        (i, part, path)
                    assert float(np.where(off, d, 0.0).max(initial=0.0)) <= \
                        COMP_STEPS * COMP_LR * 10, (i, part, path)
    flips = sum(n for _, _, n in report)
    total = sum(flipped[p].size for p in paths)
    print(f"{name}: {flips} flipped elements of {total} over {COMP_STEPS} steps "
          f"{[x for x in report if x[2]]}")
    assert flips <= min(MOST_FLIPS, total * FLIP_SHARE)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    (r,) = spawn(one_rank_compression_steps, 1, tmp_path_factory.mktemp("one_rank_comp"))
    return r


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_one_rank_mesh_compressed_steps_match_unmeshed(kind, one_rank):
    plain, meshed = one_rank[kind, False], one_rank[kind, True]
    assert [loss for loss, _ in meshed["runs"]] == [loss for loss, _ in plain["runs"]]
    for (_, g0), (_, g1) in zip(plain["runs"], meshed["runs"]):
        assert abs(g1 - g0) <= 1e-6 * abs(g0), (g0, g1)
    assert sorted(meshed["state"]) == sorted(plain["state"])
    assert any(k.startswith("comp_err") for k in plain["state"])
    for k, want in plain["state"].items():
        np.testing.assert_array_equal(meshed["state"][k], want, err_msg=k)
