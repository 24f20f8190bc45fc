"""The error-feedback residual's initial state: the port's
``training.compression.init_error_state`` against the JAX package's (the
same tree, shapes and dtype, zeros), and ``make_train_state``'s
``comp_err``, built through it, unmeshed and on a gloo mesh of two ranks:
float32 zeros of each leaf's ZeRO-1 block (``Zero1.block_shape``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_common import spawn  # noqa: E402

from repro_torch.training.compression import init_error_state  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402


def _arrays() -> dict:
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((11, 4)).astype(np.float32),
            "seg0": {"sub0": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32),
                              "scale": rng.standard_normal((2, 4)).astype(np.float32)}},
            "final_norm": np.float32(rng.standard_normal())}


def test_init_error_state_matches_the_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.training.compression import init_error_state as ref_init

    arrays = _arrays()
    ref = ref_init(jax.tree.map(jnp.asarray, arrays))
    want = [(jax.tree_util.keystr(p), tuple(leaf.shape), str(leaf.dtype), np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]]
    tree = {"embed": torch.from_numpy(arrays["embed"]).to(torch.bfloat16),
            "seg0": {"sub0": {k: torch.from_numpy(v) for k, v in arrays["seg0"]["sub0"].items()}},
            "final_norm": torch.tensor(arrays["final_norm"])}
    got = [(p, tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."), leaf.numpy())
           for p, leaf in flatten_with_path(init_error_state(tree))]
    assert [w[:3] for w in want] == [g[:3] for g in got]
    assert all(w[2] == "float32" and not w[3].any() and not g[3].any() for w, g in zip(want, got))


def test_init_error_state_keeps_each_leaf_on_its_device():
    tree = {"a": torch.ones(3, device="meta"), "b": torch.ones(2, 2, dtype=torch.bfloat16)}
    err = init_error_state(tree)
    assert err["a"].device.type == "meta" and err["a"].shape == (3,)
    assert err["b"].dtype == torch.float32 and err["b"].device.type == "cpu"
    assert not err["b"].any()


def _comp_err(state) -> list:
    return [(tuple(e.shape), e.dtype, e.device.type, bool(e.any()))
            for e in (leaf for _, leaf in flatten_with_path(state["comp_err"]))]


def test_make_train_state_builds_comp_err_through_it():
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import Zero1, make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state

    cfg = reduced_config("stablelm-3b")
    params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
    state = make_train_state(params, make_optimizer("adamw"), TrainHparams(compression="int8"))
    zero1 = Zero1(params)
    paths = [p for p, _ in flatten_with_path(params)]
    assert [p for p, _ in flatten_with_path(state["comp_err"])] == paths
    assert _comp_err(state) == [(zero1.block_shape(i), torch.float32, "cpu", False)
                                for i in range(len(paths))]
    assert "comp_err" not in make_train_state(params, make_optimizer("adamw"))


def meshed_comp_err_rank(rank, world):
    """This rank's ``comp_err`` leaves (shape, dtype, device, any nonzero)
    and its ZeRO-1 block shapes, under a (2, 1) mesh with fsdp."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import Zero1, make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state

    mesh = make_local_mesh(2, 1, device_type="cpu")
    cfg = reduced_config("stablelm-3b")
    params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
    with rules.mesh_context(mesh, fsdp=True):
        state = make_train_state(params, make_optimizer("adamw"), TrainHparams(compression="topk"))
        zero1 = Zero1(params)
        blocks = [zero1.block_shape(i) for i in range(len(flatten_with_path(params)))]
    return _comp_err(state), blocks, [tuple(p.shape) for _, p in flatten_with_path(params)]


def test_meshed_make_train_state_builds_comp_err_through_it(tmp_path):
    for got, blocks, full in spawn(meshed_comp_err_rank, 2, tmp_path):
        assert got == [(b, torch.float32, "cpu", False) for b in blocks]
        assert any(b != f for b, f in zip(blocks, full))  # fsdp cut some leaves over data
