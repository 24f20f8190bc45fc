"""The port's data pipeline and checkpoint manager against the JAX
package's, bit for bit: ``ShardedDataPipeline`` batches, shard -> host
tables, ``rescale`` plans, ``steal_from`` and ``binomial_rehost`` (the
cases of ``tests/test_data.py``); ``CheckpointManager``'s manifest bytes,
node files (member names and member bytes, bfloat16 leaves included),
restores across the two packages in float32, ``plan_resize``, atomic and
async saves, and the port's own bfloat16 round trip and resume.
"""
import dataclasses
import functools
import os
import re
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data import pipeline as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training.optimizer import make_optimizer as j_make_optimizer  # noqa: E402
from repro.training.train_step import TrainHparams as JHp  # noqa: E402
from repro.training.train_step import make_train_state as j_make_train_state  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402
from test_torch_train_common import _configs, make_batch  # noqa: E402

# --- the data pipeline -------------------------------------------------------


def _dcfg(mod, **kw):
    d = dict(vocab_size=1000, seq_len=32, global_batch=8, num_shards=64, seed=3)
    d.update(kw)
    return mod.DataConfig(**d)


@pytest.mark.parametrize("hosts", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_batches_and_shards_match_reference(hosts, seed):
    for h in range(hosts):
        j = JP.ShardedDataPipeline(_dcfg(JP, seed=seed, global_batch=12), hosts, h)
        t = TP.ShardedDataPipeline(_dcfg(TP, seed=seed, global_batch=12), hosts, h)
        assert t.local_shards == j.local_shards
        assert t.assignment.table() == j.assignment.table()
        for step in (0, 1, 17, 1000):
            jb, tb = j.batch(step), t.batch(step)
            for k in ("tokens", "targets"):
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("new_hosts", [5, 3, 8, 1])
def test_rescale_plans_match_reference(new_hosts):
    j, t = JP.ShardedDataPipeline(_dcfg(JP), 4, 0), TP.ShardedDataPipeline(_dcfg(TP), 4, 0)
    jp, tp = j.rescale(new_hosts), t.rescale(new_hosts)
    assert [(m.key, m.src, m.dst) for m in tp.moves] == [(m.key, m.src, m.dst) for m in jp.moves]
    assert tp.moved_fraction == jp.moved_fraction and tp.destinations() == jp.destinations()
    assert t.local_shards == j.local_shards
    np.testing.assert_array_equal(t.batch(5)["tokens"], j.batch(5)["tokens"])


@pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
def test_straggler_stealing_matches_reference(fraction):
    for straggler in range(4):
        for h in range(4):
            if h == straggler:
                continue
            j, t = JP.ShardedDataPipeline(_dcfg(JP), 4, h), TP.ShardedDataPipeline(_dcfg(TP), 4, h)
            assert t.steal_from(straggler, fraction) == j.steal_from(straggler, fraction)
            assert t.local_shards == j.local_shards


def test_binomial_rehost_matches_reference():
    for n in (2, 3, 7, 64):
        for shard in range(200):
            for excluded in (0, n - 1):
                got = TP.binomial_rehost(shard, n, excluded)
                assert got == JP.binomial_rehost(shard, n, excluded) and got != excluded


# --- checkpoints ---------------------------------------------------------------


@functools.cache
def _reference_state(arch: str, dtype: str = "float32", opt: str = "adamw"):
    """The reference's train state (int8 compression's residual included)
    of ``arch``'s reduced config, its parameters in ``dtype``, and its numpy
    copy."""
    cfg = _configs(arch, dtype=dtype, param_dtype=dtype)[0]
    params = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(0))
    state = j_make_train_state(params, j_make_optimizer(opt), JHp(compression="int8"))
    return state, jax.tree.map(np.asarray, state)


def _port_state(host):
    """The port's state for a reference numpy state (bfloat16 leaves come
    over as ml_dtypes arrays)."""
    return train_state_from_numpy(host, "cpu")


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("dtype,opt", [("float32", "adamw"), ("bfloat16", "adamw"),
                                       ("float32", "adafactor")])
@pytest.mark.parametrize("n_nodes", [1, 3, 4])
def test_checkpoint_files_match_reference(tmp_path, dtype, opt, n_nodes):
    """The same manifest bytes, and the same node files member by member
    (names and bytes: headers and data), bfloat16 leaves under descr
    '<V2' and Adafactor's ``f`` list included."""
    jstate, host = _reference_state("deepseek-v3-671b", dtype, opt)
    jdir, tdir = JCK.CheckpointManager(str(tmp_path / "j"), n_nodes).save(4, jstate), \
        TCK.CheckpointManager(str(tmp_path / "t"), n_nodes).save(4, _port_state(host))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    with open(os.path.join(jdir, "manifest.json"), "rb") as a, \
            open(os.path.join(tdir, "manifest.json"), "rb") as b:
        assert a.read() == b.read()
    for name in os.listdir(jdir):
        if name.endswith(".npz"):
            assert _members(os.path.join(tdir, name)) == _members(os.path.join(jdir, name))
    if dtype == "bfloat16":
        with zipfile.ZipFile(os.path.join(tdir, "node_0.npz")) as z:
            assert any(b"'descr': '<V2'" in z.read(n)[:128] for n in z.namelist())


def test_checkpoints_restore_across_packages(tmp_path):
    """float32: the reference restores the port's checkpoint and the port
    the reference's, every leaf bit for bit."""
    jstate, host = _reference_state("qwen3-moe-235b-a22b")
    tstate = _port_state(host)
    JCK.CheckpointManager(str(tmp_path / "j"), 3).save(2, jstate)
    TCK.CheckpointManager(str(tmp_path / "t"), 3).save(2, tstate)
    from_ref = TCK.CheckpointManager(str(tmp_path / "j"), 3).restore(2, tstate)
    from_port = JCK.CheckpointManager(str(tmp_path / "t"), 3).restore(2, jax.eval_shape(lambda: jstate))
    for (k, a), (_, b) in zip(flatten_with_path(from_ref), flatten_with_path(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and bool(jnp.all(a == b))


@pytest.mark.parametrize("new_n", [1, 3, 7, 9])
def test_plan_resize_matches_reference(new_n):
    jstate, host = _reference_state("qwen2.5-14b")
    j = JCK.CheckpointManager("unused", 8).plan_resize(jax.eval_shape(lambda: jstate), new_n)
    t = TCK.CheckpointManager("unused", 8).plan_resize(_port_state(host), new_n)
    assert t == j
    assert all(dst == 8 for _, _, dst in TCK.CheckpointManager("unused", 8).plan_resize(
        _port_state(host), 9))


def test_place_and_fnv1a_match_reference():
    for key in ("['params']['seg0']['sub0']['wq']", "['step']", "['opt']['f'][3]['vr']", ""):
        assert TCK._fnv1a(key) == JCK._fnv1a(key)
        for n in (1, 2, 5, 1000):
            assert TCK._place(key, n) == JCK._place(key, n)


def test_bf16_round_trip_and_atomicity(tmp_path):
    cfg = dataclasses.replace(reduced_config("mamba2-1.3b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = TM.init_train_params(torch.Generator().manual_seed(0), cfg)
    state = make_train_state(params, make_optimizer("adamw"), TrainHparams())
    mgr = TCK.CheckpointManager(str(tmp_path), n_nodes=2)
    mgr.save(1, state)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert mgr.latest_step() == 1
    back = mgr.restore(1, state)
    bf16 = [k for k, t in flatten_with_path(state) if t.dtype == torch.bfloat16]
    assert bf16
    for (k, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(state)):
        assert a.dtype == b.dtype, k
        if a.dtype == torch.bfloat16:  # the bit patterns
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k


def test_async_save(tmp_path):
    _, host = _reference_state("mamba2-1.3b")
    state = _port_state(host)
    mgr = TCK.CheckpointManager(str(tmp_path), n_nodes=2)
    t = mgr.save_async(5, state)
    leaves(state)[0].add_(1.0)  # the snapshot was taken before the thread started
    t.join(timeout=60)
    assert not t.is_alive() and mgr.latest_step() == 5
    back = mgr.restore(5, state)
    assert torch.equal(leaves(back)[0], leaves(state)[0] - 1.0)


def test_resume_after_training(tmp_path):
    """Three steps, save, a fourth; a fresh restore of the save and the same
    fourth step gives the same parameters bit for bit."""
    _, tcfg = _configs("stablelm-3b")
    opt = make_optimizer("adamw", lr=1e-3, warmup=1, total=10)
    state = make_train_state(TM.init_train_params(torch.Generator().manual_seed(0), tcfg), opt)
    step = make_train_step(tcfg, opt)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, batch=2, seq=16).items()}
    mgr = TCK.CheckpointManager(str(tmp_path), n_nodes=3)
    for _ in range(3):
        state, _ = step(state, batch)
    mgr.save(3, state)
    like = make_train_state(TM.init_train_params(torch.Generator().manual_seed(1), tcfg), opt)
    restored = mgr.restore(mgr.latest_step(), like)
    state, _ = step(state, batch)
    restored, _ = step(restored, batch)
    assert int(restored["step"]) == 4
    for a, b in zip(leaves(state["params"]), leaves(restored["params"])):
        assert torch.equal(a, b)


# --- the launcher --------------------------------------------------------------


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``launch.train --device cpu``: 3 steps and a checkpoint, then on to 5
    from it; every loss finite."""
    from repro_torch.launch import train

    args = ["--device", "cpu", "--arch", "qwen3-moe-235b-a22b", "--preset", "smoke", "--batch", "2",
            "--seq", "16", "--hosts", "2", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "3"])
    first = capsys.readouterr().out
    train.main(args + ["--steps", "5"])
    second = capsys.readouterr().out
    assert "resuming" not in first and "resuming from checkpoint step 3" in second
    losses = [float(x) for x in re.findall(r"loss=(\S+)", first + second)]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert TCK.CheckpointManager(str(tmp_path)).latest_step() == 5


def test_launcher_runs_on_cuda_by_default():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
