"""The port's spec rules against the JAX package's, in one process.

``params_pspecs``, ``cache_pspecs``, ``batch_pspecs``, ``fit_spec``,
``logical`` and ``zero1_pspecs`` of ``repro_torch.sharding.rules`` (and
``repro_torch.training.optimizer``) must give the same specs as
``repro.sharding.rules`` (``repro.training.optimizer``) for every
architecture at its published shapes (``jax.eval_shape``, nothing
allocated), at the layouts (1, 1), (2, 4), (16, 16) and (2, 16, 16), with
fsdp on and off and both expert layouts.  The reference's rules run
against a stand-in mesh (an object with ``axis_names`` and a ``shape``
dict), the port's against a ``MeshLayout``: the rules read nothing else.
Specs are compared entry by entry, a one-name tuple entry read as the name
(JAX 0.9's ``PartitionSpec`` stores it so).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, production_layout  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH_NAMES = sorted(REF_ARCHS)
LAYOUTS = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


def _stand_in(names, sizes):
    return SimpleNamespace(axis_names=tuple(names), shape=dict(zip(names, sizes)))


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def _norm(tree):
    """Spec tree -> the same tree with each spec a plain tuple of
    normalised entries (both packages' spec types, dicts and lists)."""
    if isinstance(tree, (JR.P, TR.P)):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    raise TypeError(f"unexpected spec leaf {tree!r}")


def _shapes(tree):
    """A ShapeDtypeStruct tree -> shape records the port's rules read."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return SimpleNamespace(shape=tuple(tree.shape), ndim=len(tree.shape))


@functools.cache
def _param_shapes(arch: str):
    cfg = ref_get_config(arch)
    return jax.eval_shape(functools.partial(JM.init_params, cfg=cfg), jax.random.PRNGKey(0))


@functools.cache
def _cache_shapes(arch: str):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda: JM.init_cache(cfg, 128, 4096))


@functools.cache
def _opt_shapes(arch: str, name: str):
    opt = JO.make_optimizer(name)
    return jax.eval_shape(opt.init, _param_shapes(arch))


def _both(names, sizes, fsdp, elayout, fn_ref, fn_port):
    with JR.mesh_context(_stand_in(names, sizes), fsdp=fsdp, expert_layout=elayout):
        ref = fn_ref()
    with TR.mesh_context(MeshLayout(names, sizes), fsdp=fsdp, expert_layout=elayout):
        port = fn_port()
    return _norm(ref), _norm(port)


@pytest.mark.parametrize("elayout", ["ep", "tp"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_pspecs_match_reference(arch, mesh, fsdp, elayout):
    shapes = _param_shapes(arch)
    ref, port = _both(*LAYOUTS[mesh], fsdp, elayout,
                      lambda: JR.params_pspecs(shapes),
                      lambda: TR.params_pspecs(_shapes(shapes)))
    assert port == ref


@pytest.mark.parametrize("mesh", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_and_batch_pspecs_match_reference(arch, mesh):
    cache = _cache_shapes(arch)
    ref, port = _both(*LAYOUTS[mesh], True, "ep",
                      lambda: JR.cache_pspecs(cache),
                      lambda: TR.cache_pspecs(_shapes(cache)))
    assert port == ref
    cfg = ref_get_config(arch)
    B, S = 256, 4096
    batch = {"tokens": np.zeros((B, S), np.int32), "targets": np.zeros((B, S), np.int32),
             "positions": np.zeros((3, B, S), np.int32),
             "embeds": np.zeros((B, 8, cfg.d_model), np.float32),
             "odd": np.zeros((3, S), np.int32)}
    ref, port = _both(*LAYOUTS[mesh], True, "ep",
                      lambda: JR.batch_pspecs(batch), lambda: TR.batch_pspecs(batch))
    assert port == ref


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero1_pspecs_match_reference(arch, mesh, opt):
    shapes, state = _param_shapes(arch), _opt_shapes(arch, opt)
    assert set(state) >= ({"f"} if opt == "adafactor" else {"m", "v", "master"})

    def ref():
        return JO.zero1_pspecs(shapes, JR.params_pspecs(shapes), state)

    def port():
        p = _shapes(shapes)
        return TO.zero1_pspecs(p, TR.params_pspecs(p), _shapes(state))

    for fsdp in (False, True):
        r, t = _both(*LAYOUTS[mesh], fsdp, "ep", ref, port)
        assert t == r


@pytest.mark.parametrize("mesh", sorted(LAYOUTS))
def test_fit_spec_and_logical_match_reference(mesh):
    names, sizes = LAYOUTS[mesh]
    shapes = [(256, 4096), (3, 48), (16, 17), (64, 6, 5), (2, 16, 16, 512)]
    axes = [("dp", "tp"), ("tp", "fsdp"), ("sp", None), ("fsdp", "tp", "dp"),
            (None, "dp", "tp", "sp")]
    for fsdp in (False, True):
        for shape, ax in zip(shapes, axes):
            for fn, args in (("logical", ax), ("fitted", (shape, *ax))):
                r, t = _both(names, sizes, fsdp, "ep",
                             lambda: getattr(JR, fn)(*args), lambda: getattr(TR, fn)(*args))
                assert t == r, (fn, args)
            stand = _stand_in(names, sizes)
            with JR.mesh_context(stand, fsdp=fsdp):
                resolved = [JR._resolve(a, stand) for a in ax]
                r = _norm(JR.fit_spec(resolved, shape, stand))
            with TR.mesh_context(MeshLayout(names, sizes), fsdp=fsdp):
                t = _norm(TR.fit_spec(resolved, shape, MeshLayout(names, sizes)))
            assert t == r
    # no mesh: every spec is empty, on both sides
    assert _norm(TR.logical("dp", "tp")) == _norm(JR.logical("dp", "tp")) == ()


def test_unknown_logical_axis_raises_on_both():
    stand = _stand_in(*LAYOUTS["2x4"])
    with pytest.raises(ValueError, match="unknown logical axis"):
        JR._resolve("xp", stand)
    with pytest.raises(ValueError, match="unknown logical axis"):
        TR._resolve("xp", MeshLayout(*LAYOUTS["2x4"]))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b", "recurrentgemma-9b"])
def test_per_layer_tree_takes_the_stacked_specs(arch):
    """The port serves from a per-layer tree (``layers[l]``, no stacked
    dim): each of its leaves takes the stacked leaf's spec without the
    layer dim, and the placements follow the spec."""
    cfg = reduced_config(arch)
    params = TM.init_train_params(torch.Generator().manual_seed(0), cfg)
    flat = TM.per_layer(params, cfg)
    with TR.mesh_context(MeshLayout(("data", "model"), (2, 2)), fsdp=True):
        stacked = _norm(TR.params_pspecs(params))
        layered = _norm(TR.params_pspecs(flat))
    from repro_torch.models.blocks import build_segments, layer_index

    seen = 0
    for i, seg in enumerate(build_segments(cfg)):
        for j in range(len(seg.unit)):
            sub = stacked[f"seg{i}"][f"sub{j}"]
            for s in range(seg.count):
                got = layered["layers"][layer_index(seg, s, j)]
                want = jax.tree.map(lambda spec: spec[1:], sub,
                                    is_leaf=lambda x: isinstance(x, tuple))
                assert got == want
                seen += 1
    assert seen == cfg.num_layers
    assert layered["embed"] == stacked["embed"]


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    lay = production_layout(multi_pod=True)
    assert TR.placements(TR.P(("pod", "data"), None, "model"), lay) == [Shard(0), Shard(0), Shard(2)]
    assert TR.placements(TR.P(None, "data"), lay) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="major to minor"):
        TR.placements(TR.P(("data", "pod")), lay)
    x = np.arange(2 * 16 * 8).reshape(32, 8)
    coord = {"pod": 1, "data": 3, "model": 5}
    got = TR.local_slice(x, TR.P(("pod", "data"), None), lay, coord)
    assert np.array_equal(got, x[19:20])  # block 1 * 16 + 3 of 32
    got = TR.local_slice(x, TR.P(None, "model"), MeshLayout(("model",), (4,)), {"model": 2})
    assert np.array_equal(got, x[:, 4:6])
