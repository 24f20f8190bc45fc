"""The port's ``apply_moe`` under a (2, 2) ``("data", "model")`` mesh of 4
gloo ranks on the CPU, against the JAX package's meshed ``apply_moe`` (a
subprocess with 4 CPU devices, a mesh of Auto axes, jitted).

Reduced Qwen3-MoE in float32 (8 experts, top 2): both branches (B, S = 4,
16 takes the expert-parallel body, 4, 1 the dense GShard path), both expert
layouts, fsdp on and off, the hash and top-k routers, and capacity factors
8.0 and 0.5.  At 0.5 the EP body drops tokens per data shard, so the
reference's meshed output differs from its unmeshed one; the port must
match the meshed one.  Each rank holds its block of the expert weights
(``rules.params_local``) and its data shard of the tokens; the shards put
together must match the reference within ``TOL`` (float32, of max(1,
max |reference|)), and the top-k aux loss within the same.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_common import (  # noqa: E402
    MOE_CASES,
    moe_case_name,
    moe_mesh_rank,
    reference,
    spawn,
)

TOL = 1e-5

_REFERENCE = r"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.models.layers import moe
from repro.sharding import rules

CASES = %r
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
base = reduced_config("qwen3-moe-235b-a22b")
base = dataclasses.replace(base, dtype="float32", param_dtype="float32")
p = moe.init_moe(jax.random.PRNGKey(0), base)
out = {f"p/{k}": np.asarray(v) for k, v in p.items()}
rng = np.random.default_rng(0)
for B, S in ((4, 16), (4, 1)):
    out[f"{B}x{S}/x"] = rng.standard_normal((B, S, base.d_model)).astype(np.float32)
    out[f"{B}x{S}/tok"] = rng.integers(0, base.vocab_size, (B, S)).astype(np.int32)
for name, router, cf, (B, S), fsdp, lay in CASES:
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, router=router,
                                                           capacity_factor=cf))
    x, tok = jnp.asarray(out[f"{B}x{S}/x"]), jnp.asarray(out[f"{B}x{S}/tok"])
    fn = jax.jit(lambda p, x, t: moe.apply_moe(p, x, t, 3, cfg))
    with rules.mesh_context(mesh, fsdp=fsdp, expert_layout=lay):
        y, aux = fn(p, x, tok)
    y0, _ = moe.apply_moe(p, x, tok, 3, cfg)
    out[name] = np.asarray(y)
    out[name + "/aux"] = np.asarray(aux)
    out[name + "/unmeshed"] = np.asarray(y0)
np.savez(sys.argv[1], **out)
""" % ([(moe_case_name(*c), *c) for c in MOE_CASES],)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(_REFERENCE, tmp_path_factory.mktemp("ref_moe"))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    arrays = {k: v for k, v in ref.items() if k.startswith("p/") or k.endswith(("/x", "/tok"))}
    return spawn(moe_mesh_rank, 4, tmp_path_factory.mktemp("moe_ranks"), arrays)


@pytest.mark.parametrize("case", MOE_CASES, ids=[moe_case_name(*c) for c in MOE_CASES])
def test_meshed_apply_moe_matches_reference(case, ref, ranks):
    name = moe_case_name(*case)
    router, cf, (B, S), fsdp, lay = case
    want = ref[name]
    scale = max(1.0, float(np.abs(want).max()))
    # rank = 2 * data + model; both model ranks of a data shard hold it
    shards = [ranks[2 * d][name][0] for d in range(2)]
    for d in range(2):
        np.testing.assert_array_equal(ranks[2 * d + 1][name][0], shards[d])
    got = np.concatenate(shards)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * scale, np.abs(got - want).max()
    for r in ranks:
        assert abs(r[name][1] - float(ref[name + "/aux"])) <= TOL
    # the blocks each rank held, as params_pspecs cuts them: experts_wi
    # takes the MLP rule (the rules are first-match), its ff width over
    # model; experts_wo its experts ("ep") or its ff width ("tp"); the
    # model width over data with fsdp
    E, D, Fe = ref["p/experts_wi"].shape
    d = D // 2 if fsdp else D
    assert ranks[0][name][2] == (E, d, Fe // 2)
    assert ranks[0][name][3] == ((E // 2, Fe, d) if lay == "ep" else (E, Fe // 2, d))
    dense = (B // 2) * S * 2 <= 4 * E  # the branch this case takes
    if cf == 0.5 and not dense:
        # the EP body's per-shard capacity drops other tokens than the
        # unmeshed layer does: the meshed reference is the one to match
        assert np.abs(ref[name + "/unmeshed"] - want).max() > 100 * TOL * scale
