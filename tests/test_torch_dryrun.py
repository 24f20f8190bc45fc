"""The port's shapes, input and cache specs, dry run and collective
accounting, against the JAX package.

* ``SHAPES`` and ``shape_applicable`` equal the reference's for every
  architecture;
* ``model.input_specs`` and ``cache_specs`` (``meta`` tensors) equal the
  reference's (``ShapeDtypeStruct``s, ``jax.eval_shape``) in shape and
  dtype for every architecture × shape;
* the dry run's per-device argument bytes equal the sum of the blocks
  that the reference's ``params_pspecs`` + ``zero1_pspecs`` +
  ``batch_pspecs`` cut on a stand-in mesh of the production layout, for
  two cells (StableLM-3B × train_4k × 16×16 with AdamW; Mamba2-1.3B ×
  train_4k × 2×16×16, whose ``pod`` axis adds DCN traffic);
* ``CostMode``'s collective bytes equal a hand count on a small meshed MLP
  (a (2, 2) mesh over a fake process group of 4 ranks, ``meta`` tensors);
* one production-size cell (StableLM-3B × train_4k × 16×16) runs end to
  end within ``CELL_S`` seconds, with the collective and memory terms
  filled in.
"""
import math
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

#: the most seconds the production-size cell may take on this CPU (it
#: takes about 20)
CELL_S = 120

_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


class _Layout:
    """A stand-in mesh for the reference's rules: axis names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)


def _same(jtree, ttree, what):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    from repro_torch.tree import flatten_with_path

    tl = flatten_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl], what
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape), (what, path)
        assert _DTYPES[jnp.dtype(j.dtype).type] == t.dtype, (what, path, j.dtype, t.dtype)
        assert t.device.type == "meta"


def test_shapes_and_applicability_match_reference():
    assert {k: vars(v) for k, v in TC.SHAPES.items()} == {k: vars(v) for k, v in JC.SHAPES.items()}
    for arch in JC.ARCHS:
        for name in JC.SHAPES:
            assert TC.shape_applicable(TC.get_config(arch), TC.SHAPES[name]) == \
                JC.shape_applicable(JC.get_config(arch), JC.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_input_and_cache_specs_match_reference(arch):
    for name, shape in JC.SHAPES.items():
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        _same(JM.input_specs(jcfg, shape), TM.input_specs(tcfg, TC.SHAPES[name]), (arch, name))
        if shape.kind == "train":
            continue
        _same(JM.cache_specs(jcfg, shape), TM.cache_specs(tcfg, TC.SHAPES[name]), (arch, name))


def _block_bytes(tree, specs, layout) -> int:
    """The bytes of rank 0's blocks of ``tree`` (``ShapeDtypeStruct``s) cut
    by ``specs``."""
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JR.P))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            cut = math.prod(layout.shape[a] for a in names)
            assert dim % cut == 0
            n *= dim // cut
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,multi", [("stablelm-3b", False), ("mamba2-1.3b", True)])
def test_dry_run_argument_bytes_match_reference_blocks(arch, multi):
    cfg = JC.get_config(arch)
    shape = JC.SHAPES["train_4k"]
    layout = (_Layout(("pod", "data", "model"), (2, 16, 16)) if multi
              else _Layout(("data", "model"), (16, 16)))
    with JR.mesh_context(layout, fsdp=cfg.fsdp, expert_layout="ep"):
        params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
        n_params = JM.count_params(params)
        opt = JO.make_optimizer("adafactor" if n_params > dryrun.ADAFACTOR_THRESHOLD else "adamw")
        state = jax.eval_shape(lambda: JT.make_train_state(
            JM.init_params(jax.random.PRNGKey(0), cfg), opt, JT.TrainHparams()))
        pspecs = JR.params_pspecs(params)
        batch = JM.input_specs(cfg, shape)
        want = (_block_bytes(state["params"], pspecs, layout)
                + _block_bytes(state["opt"], JO.zero1_pspecs(params, pspecs, state["opt"]), layout)
                + _block_bytes(batch, JR.batch_pspecs(batch), layout) + 4)  # + the 0-dim step
    row = dryrun.run_cell(arch, "train_4k", multi, verbose=False)
    assert row["status"] == "ok" and row["n_params"] == n_params
    assert row["memory"]["argument_size_in_bytes"] == want
    assert row["memory"]["peak_live_bytes"] > want
    assert row["roofline"]["coll_bytes"] > 0
    assert (row["roofline"]["dcn_bytes"] > 0) == multi


def test_cost_mode_counts_a_meshed_mlp_by_hand():
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models.layers.common import apply_mlp
    from repro_torch.roofline.op_cost import CostMode
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(TC.reduced_config("stablelm-3b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    D, F, B, S = cfg.d_model, cfg.d_ff, 2, 8
    if dist.is_initialized():  # a dry-run cell's fake group
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with rules.mesh_context(mesh, fsdp=True), torch.device("meta"):
            p = {"wi": torch.empty(D // 2, F // 2, dtype=torch.bfloat16),
                 "wg": torch.empty(D // 2, F // 2, dtype=torch.bfloat16),
                 "wo_mlp": torch.empty(F // 2, D // 2, dtype=torch.bfloat16)}
            x = torch.empty(B, S, D, dtype=torch.bfloat16)
            with CostMode() as mode:
                apply_mlp(p, x, cfg)
    finally:
        dist.destroy_process_group()
    c = mode.cost
    block = (D // 2) * (F // 2) * 2  # bytes of one weight block
    gathers = 3 * (block + 2 * block)  # wi, wg, wo_mlp over data: operand + result
    reduce = 2 * (B * S * D * 2)  # the row-parallel output over model: operand + result
    assert c.coll_by_kind == {"all-gather": [3, gathers], "all-reduce": [1, reduce]}
    assert c.coll_bytes == gathers + reduce and c.dcn_bytes == 0


def test_production_cell_runs_end_to_end():
    t0 = time.time()
    row = dryrun.run_cell("stablelm-3b", "train_4k", False, verbose=False)
    seconds = time.time() - t0
    assert row["status"] == "ok" and row["chips"] == 256 and row["device"] == "meta"
    roof = row["roofline"]
    assert roof["flops"] > 0 and roof["coll_bytes"] > 0 and roof["dcn_bytes"] == 0
    # fsdp's weight gathers, ZeRO-1's gradient reduce-scatters and the
    # tensor-parallel all-reduces
    assert set(roof["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert 0 < roof["useful_ratio"] < 1
    assert seconds < CELL_S, seconds


def test_long_500k_is_skipped_where_the_reference_skips_it():
    for arch in JC.ARCHS:
        ok, _ = JC.shape_applicable(JC.get_config(arch), JC.SHAPES["long_500k"])
        if not ok:
            assert dryrun.run_cell(arch, "long_500k", False, verbose=False)["status"] == "skipped"
