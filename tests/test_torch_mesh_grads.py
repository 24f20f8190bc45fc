"""Gradients through the port's ``apply_moe`` under a (2, 2) ``("data",
"model")`` mesh of 4 gloo ranks, against the JAX package's meshed
``jax.grad`` of the same layer (a subprocess with 4 CPU devices, a mesh of
Auto axes, jitted).

The objective is ``sum(y * R) + aux`` with a fixed random ``R``: every
gradient — the tokens ``x``, ``experts_wi``/``wg``/``wo`` and, under top-k,
the ``router`` — must lie within ``TOL`` of the reference's (float32, of
max(1, max |reference|)).  Both branches (B, S = 4, 16 takes the
expert-parallel body, 4, 1 the dense GShard path), both expert layouts,
fsdp on and off, the hash and top-k routers, and at capacity factor 0.5
the EP body's drops (where the meshed reference differs from the unmeshed
one).  Each rank backpropagates its data shard's part of ``sum(y * R)``
and the aux loss; its expert-weight gradient is its block
(``params_local`` of the reference's), a leaf replicated over ``data``
(the router, the experts without fsdp) is summed over ``data`` as the
train step sums it, and ``x``'s is the rank's data shard.  The
collectives without a gradient rule must refuse a tensor that requires
one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_common import reference, spawn  # noqa: E402
from test_torch_mesh_train_common import GRAD_CASES, grad_case_name, moe_grad_rank  # noqa: E402

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
rng = np.random.default_rng(1)
for B, S in ((4, 16), (4, 1)):
    out[f"{B}x{S}/x"] = rng.standard_normal((B, S, base.d_model)).astype(np.float32)
    out[f"{B}x{S}/tok"] = rng.integers(0, base.vocab_size, (B, S)).astype(np.int32)
    out[f"{B}x{S}/R"] = rng.standard_normal((B, S, base.d_model)).astype(np.float32)
for name, router, cf, (B, S), fsdp, lay in CASES:
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, router=router,
                                                           capacity_factor=cf))
    x, tok, R = (jnp.asarray(out[f"{B}x{S}/{k}"]) for k in ("x", "tok", "R"))

    def objective(p, x):
        y, aux = moe.apply_moe(p, x, tok, 3, cfg)
        return jnp.sum(y * R) + aux

    with rules.mesh_context(mesh, fsdp=fsdp, expert_layout=lay):
        loss, (gp, gx) = jax.jit(jax.value_and_grad(objective, argnums=(0, 1)))(p, x)
    out[name + "/loss"] = np.asarray(loss)
    out[name + "/x"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"{name}/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
""" % ([(grad_case_name(*c), *c) for c in GRAD_CASES],)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(_REFERENCE, tmp_path_factory.mktemp("ref_moe_grads"))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    arrays = {k: v for k, v in ref.items() if k.startswith("p/") or k.endswith(("/x", "/tok", "/R"))
              and k.count("/") == 1}
    return spawn(moe_grad_rank, 4, tmp_path_factory.mktemp("moe_grad_ranks"), arrays)


def _block(full, rank, name, fsdp, lay):
    """The reference gradient's block that ``rank`` holds (its spec under
    the case's mesh context, cut as ``params_local`` cuts it)."""
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.sharding import rules

    layout = MeshLayout(("data", "model"), (2, 2))
    with rules.mesh_context(layout, fsdp=fsdp, expert_layout=lay):
        spec = rules.param_spec(name, full.shape)
    return rules.local_slice(full, spec, layout, {"data": rank // 2, "model": rank % 2})


@pytest.mark.parametrize("case", GRAD_CASES, ids=[grad_case_name(*c) for c in GRAD_CASES])
def test_meshed_moe_gradients_match_reference(case, ref, ranks):
    name = grad_case_name(*case)
    router, cf, (B, S), fsdp, lay = case
    for rank, r in enumerate(ranks):
        got = r[name]
        assert "error" not in got, got.get("error")
        assert abs(got["loss"] - float(ref[name + "/loss"])) <= TOL * max(1.0, abs(float(ref[name + "/loss"])))
        assert got["x"] is not None, ("x", "no gradient")
        want_x = ref[name + "/x"][(rank // 2) * B // 2:(rank // 2 + 1) * B // 2]
        scale = max(1.0, float(np.abs(ref[name + "/x"]).max()))
        assert np.abs(got["x"] - want_x).max() <= TOL * scale, ("x", rank)
        for k in ("experts_wi", "experts_wg", "experts_wo"):
            assert got[k] is not None, (k, "no gradient")
            want = _block(ref[f"{name}/{k}"], rank, k, fsdp, lay)
            scale = max(1.0, float(np.abs(ref[f"{name}/{k}"]).max()))
            assert got[k].shape == want.shape, (k, got[k].shape, want.shape)
            assert np.abs(got[k] - want).max() <= TOL * scale, (k, rank, np.abs(got[k] - want).max())
        if router == "topk":
            scale = max(1.0, float(np.abs(ref[name + "/router"]).max()))
            assert np.abs(got["router"] - ref[name + "/router"]).max() <= TOL * scale


def test_collectives_without_a_rule_refuse_autograd(ranks):
    for r in ranks:
        assert r["refused"] == {"all_reduce": True, "all_gather": True, "reduce_scatter": True,
                                "no_grad_runs": 16.0}
