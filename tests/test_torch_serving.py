"""The port's ``ServingTier`` (``repro_torch.serving.engine``) against the
JAX package's on the CPU: the reduced hash-routed Qwen3-MoE, the same
parameters (JAX ``init_params`` carried over by ``params_from_numpy``) and
the same requests, served before and after a replica fails.  Routes and
generated tokens must be identical.  Also: the entry points run on CUDA by
default and raise without it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingTier as RefServingTier  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import Replica, Request, ServingTier  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
N_NEW = 4


def _hash(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="hash"))


def _requests(vocab: int):
    """24 sessions with prompts of 5-8 tokens (so groups are left-padded)."""
    rng = np.random.default_rng(3)
    return [
        (f"user-{i}", rng.integers(0, vocab, size=int(rng.integers(5, 9))).astype(np.int32))
        for i in range(24)
    ]


def test_serving_tier_matches_reference_through_a_failure():
    jcfg, tcfg = _hash(ref_reduced_config(ARCH)), _hash(reduced_config(ARCH))
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    ref = RefServingTier(jcfg, jparams, 3, max_len=16)
    port = ServingTier(tcfg, tparams, 3, max_len=16, device="cpu")
    reqs = _requests(jcfg.vocab_size)
    ids = [sid for sid, _ in reqs]
    routes = None
    for failed in (None, 1):
        if failed is not None:
            ref.fail(failed), port.fail(failed)
        want = ref.serve([RefRequest(s, p, N_NEW) for s, p in reqs])
        got = port.serve([Request(s, p, N_NEW) for s, p in reqs])
        assert sorted(got) == sorted(want) == sorted(ids)
        for sid in ids:
            assert got[sid].dtype == np.int32
            np.testing.assert_array_equal(got[sid], np.asarray(want[sid]))
        now = [port.router.route(sid) for sid in ids]
        assert now == [ref.router.route(sid) for sid in ids]
        if routes is not None:  # only the failed replica's sessions moved
            assert all(a == b or a == failed for a, b in zip(routes, now))
            assert failed not in now and now != routes
        routes = now
    assert sum(r.steps_served for r in port.replicas) == sum(r.steps_served for r in ref.replicas)


def test_replicas_share_the_parameter_tensors():
    cfg = _hash(reduced_config(ARCH))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    tier = ServingTier(cfg, params, 3, device="cpu")
    tier.scale_up(params)
    assert len(tier.replicas) == 4
    assert all(r.params is params for r in tier.replicas)
    assert tier.scale_down() == 3 and len(tier.replicas) == 3


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "6", "--new-tokens", "2",
                "--fail-replica", "1"])
    out = capsys.readouterr().out
    assert "6 requests on 3 replicas (cpu)" in out and "6 requests still served" in out


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = reduced_config("stablelm-3b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    for make in (lambda: ServingTier(cfg, params, 3), lambda: Replica(cfg, params),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="params lie on cpu"):
        Replica(cfg, params, device="meta")
