"""The training kernels' wrappers (``repro_torch.kernels.train``) on the
CPU, where each runs its plain version: the fused AdamW update with the
clip's scale folded in, bit for bit what the clip's own pass followed by
the update did before the fold, over every dtype case the kernel takes and
across slices; the train step with AdamW and a biting clip against the JAX
package's jitted step (``test_torch_train_common.TOL``); the radix select's
plain rounds against ``torch.topk`` and ``jax.lax.top_k`` on the edge cases,
bit for bit; the wrappers' refusals; and the module importing where there
is no ``nvcc``.  The kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.kernels import train as T  # noqa: E402
from repro_torch.training import compression as TC  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TT  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train_common import run_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns (bf16 as int16, float32 as int32)."""
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


def _update_as_before(opt, grads, state, params, step):
    """``AdamW.update``'s plain loop as it stood before the clip's scale was
    folded in, transcribed: the reference the fold is held to."""
    flat_p = leaves(params)
    lr = opt.lr_fn(step).to(flat_p[0].device)
    t = torch.as_tensor(step, device=lr.device).to(torch.float32) + 1.0
    c1 = TO._f32(1.0, lr) - TO._f32(opt.b1, lr) ** t
    c2 = TO._f32(1.0, lr) - TO._f32(opt.b2, lr) ** t
    lr_wd = lr * TO._f32(opt.weight_decay, lr)
    refs = leaves(state["master"]) if opt.master_weights else [None] * len(flat_p)
    with torch.no_grad():
        for g, m, v, ref, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
                                   refs, flat_p):
            pieces = (g, m, v, p) if ref is None else (g, m, v, p, ref)
            for sl in T.flat_slices(*(x.contiguous() if x is g else x for x in pieces)):
                g_s, m_s, v_s, p_s = sl[:4]
                r_s = p_s.float() if ref is None else sl[4]
                g_s = g_s.float()
                m_s.mul_(opt.b1).add_(g_s * (1 - opt.b1))
                v_s.mul_(opt.b2).add_(g_s.square().mul_(1 - opt.b2))
                u = (m_s / c1).mul_(lr).div_((v_s / c2).sqrt_().add_(opt.eps))
                decay = r_s * lr_wd
                r_s.sub_(u).sub_(decay)
                p_s.copy_(r_s)


def _leaves(rng, gdtype, pdtype, n_big: int):
    """A tree of three leaves (one of ``n_big`` elements, an odd-shaped one,
    a single element) with seeded parameters and gradients, the moments
    from one earlier step's worth of values."""
    shapes = {"a": (n_big,), "b": (3, 7, 5), "c": (1,)}
    params = {k: torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32)).to(pdtype)
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.normal(0, 2.0, s).astype(np.float32)).to(gdtype)
             for k, s in shapes.items()}
    grads["b"].view(-1)[:4] = torch.tensor([0.0, -0.0, 1e-40, -7e15]).to(gdtype)
    return params, grads


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("sliced", [False, True], ids=["one-slice", "many-slices"])
@pytest.mark.parametrize("scaled", ["below-1", "one", "none"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "no-master"])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32], ids=["p-bf16", "p-f32"])
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32], ids=["g-bf16", "g-f32"])
def test_adamw_grad_scale_equals_the_clip_then_the_update(gdtype, pdtype, master, scaled, sliced,
                                                          monkeypatch):
    """Two steps: ``update(..., grad_scale=s)`` leaves every moment, master
    weight and parameter bit for bit where ``_scale_to`` (the clip's own
    pass) followed by the update as it stood before left them; the
    gradients themselves untouched.  ``many-slices`` patches ``SLICE`` so
    the largest leaf spans several slices and a ragged last one."""
    if sliced:
        monkeypatch.setattr(T, "SLICE", 1000)
    rng = np.random.default_rng(11)
    opt = TO.AdamW(TO.warmup_cosine(1e-2, 1, 10), master_weights=master)
    params, _ = _leaves(rng, gdtype, pdtype, 4321)
    folded = {"params": params, "opt": opt.init(params)}
    before = _clone(folded)
    for step in range(2):
        _, grads = _leaves(rng, gdtype, pdtype, 4321)
        gn = TO.Zero1(grads).global_norm(leaves(grads))
        max_norm = 0.5 * float(gn) if scaled == "below-1" else 10.0 * float(gn)
        kept = _clone(grads)
        scale = None if scaled == "none" else TT._clip_scale(max_norm, gn)
        opt.update(grads, folded["opt"], folded["params"], step, grad_scale=scale)
        for k in grads:  # the fold writes no scaled copy
            assert np.array_equal(_bits(grads[k]), _bits(kept[k])), k
        if scale is not None:
            assert (float(scale) < 1.0) == (scaled == "below-1")
            TT._scale_to(leaves(kept), max_norm, gn)
        _update_as_before(opt, kept, before["opt"], before["params"], step)
        for name in ("params", "opt"):
            for a, b in zip(leaves(folded[name]), leaves(before[name])):
                assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), (name, step)
    assert T.launches == dict.fromkeys(T.KINDS, 0)  # the CPU launches nothing


def test_adamw_without_a_scale_equals_the_update_as_before():
    rng = np.random.default_rng(12)
    opt = TO.AdamW(TO.warmup_cosine(1e-3, 0, 10))
    params, grads = _leaves(rng, torch.bfloat16, torch.bfloat16, 777)
    a = {"params": params, "opt": opt.init(params)}
    b = _clone(a)
    opt.update(grads, a["opt"], a["params"], 3)
    _update_as_before(opt, grads, b["opt"], b["params"], 3)
    for x, y in zip(leaves(a), leaves(b)):
        assert np.array_equal(_bits(x), _bits(y))


def test_adamw_updates_meta_tensors():
    """The dry run's path: the plain version over ``meta`` tensors (shapes
    only)."""
    opt = TO.AdamW(TO.warmup_cosine(1e-3, 0, 10))
    with torch.device("meta"):
        params = {"w": torch.empty(4, 8, dtype=torch.bfloat16)}
        grads = {"w": torch.empty(4, 8, dtype=torch.bfloat16)}
        state = opt.init(params)
        gn = torch.ones(())
    opt.update(grads, state, params, torch.zeros((), dtype=torch.int32, device="meta"),
               grad_scale=TT._clip_scale(1.0, gn))
    assert state["m"]["w"].device.type == "meta"


#: the train step with AdamW and a biting clip (0.05 of a gradient norm
#: near 0.4): without master weights, over two microbatches (float32
#: gradients), and with SLICE patched so each leaf spans several slices
FOLD_CASES = {"no-master": (dict(master_weights=False), dict(clip_norm=0.05), None),
              "accum2": ({}, dict(grad_accum=2, clip_norm=0.05), None),
              "slices": ({}, dict(clip_norm=0.05), 4096)}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_train_step_with_the_folded_clip_matches_reference(case, monkeypatch):
    opt_kw, hp, slice_size = FOLD_CASES[case]
    if slice_size is not None:
        monkeypatch.setattr(T, "SLICE", slice_size)
    jm, _ = run_steps("stablelm-3b", "adamw", opt_kw=opt_kw, **hp)
    assert float(jm["grad_norm"]) > hp["clip_norm"]  # the clip was active


def test_train_step_hands_adamw_the_scale_and_adafactor_scaled_gradients(monkeypatch):
    """AdamW's update gets the clip's scale and gradients the clip left as
    they were; Adafactor's gets no scale and the gradients scaled."""
    seen = []

    def spy(cls):
        real = cls.update

        def update(self, grads, state, params, step, cuts=None, **kw):
            seen.append((cls.__name__, kw.get("grad_scale"), [g.clone() for g in leaves(grads)]))
            return real(self, grads, state, params, step, cuts=cuts, **kw)

        monkeypatch.setattr(cls, "update", update)

    spy(TO.AdamW)
    spy(TO.Adafactor)
    grads = {"w": torch.full((4,), 3.0)}
    for name in ("adamw", "adafactor"):
        opt = TO.make_optimizer(name, lr=1e-3, warmup=0, total=10)
        params = {"w": torch.ones(4)}
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        zero1 = TO.Zero1(params)
        gn = zero1.global_norm(leaves(grads))
        hp = TT.TrainHparams(clip_norm=1.0)
        monkeypatch.setattr(TT, "loss_and_grads", lambda p, b, c: (
            torch.zeros(()), {"loss": torch.zeros(())}, [grads["w"].clone()]))
        monkeypatch.setattr(TT, "zero1_layout", lambda cfg: zero1)
        TT.make_train_step(None, opt, hp)(state, {"tokens": torch.zeros((1, 1))})
        cls, scale, got = seen[-1]
        want = float(TT._clip_scale(1.0, gn))
        if name == "adamw":
            assert cls == "AdamW" and float(scale) == want
            assert torch.equal(got[0], grads["w"])
        else:
            assert cls == "Adafactor" and scale is None
            assert torch.equal(got[0], grads["w"] * want)


# ---------------------------------------------------------------------------
# the radix select
# ---------------------------------------------------------------------------


def _select_cases():
    rng = np.random.default_rng(21)
    ties = (rng.integers(-40, 40, size=5000) / 8).astype(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-39,
                        -2e-38, 3.4e38, -3.4e38, 1.0, -1.0, 1.0, 0.5], np.float32)
    subnormal = (rng.integers(1, 1 << 23, size=300) * np.float32(1e-45)).astype(np.float32)
    zeros = np.zeros(33, np.float32)
    zeros[::2] = -0.0
    return {"ties": ties, "special": special, "subnormal": subnormal, "zeros": zeros,
            "normal": rng.normal(size=(17, 31)).astype(np.float32)}


SELECT_CASES = _select_cases()


def _ks(n: int):
    return sorted({1, 2, max(1, n // 20), n // 2 or 1, n - 1 or 1, n})


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_radix_select_plain_equals_topk_bit_for_bit(case):
    """The plain rounds' threshold equals ``torch.topk``'s k-th value and
    ``jax.lax.top_k``'s, bit for bit, at k = 1 and k = numel among others:
    NaN above inf, ``-0.0`` a magnitude of 0, subnormals, ties."""
    x = SELECT_CASES[case]
    mags = np.abs(x).reshape(-1)
    for k in _ks(mags.size):
        got = T.radix_select_plain(torch.from_numpy(x), k)
        want = torch.topk(torch.from_numpy(mags), k).values[-1]
        ref = np.asarray(jax.lax.top_k(jnp.asarray(mags), k)[0][-1])
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got) == _bits(want) == ref.view(np.int32), (case, k)
        assert np.array_equal(_bits(T.radix_select(torch.from_numpy(x), k)), _bits(got))
    assert T.launches == dict.fromkeys(T.KINDS, 0)


def test_radix_select_reduces_each_round():
    """``reduce`` sees each round's histogram once, between the two steps:
    a reduce that doubles every count (two identical blocks) gives the
    k-th of the doubled multiset, the (k+1)//2-th of one block."""
    x = torch.from_numpy(SELECT_CASES["ties"])
    seen = []

    def double(hist):
        seen.append(hist.numel())
        return hist * 2

    for k in (1, 2, 7, 999, 10000):
        seen.clear()
        got = T.radix_select(x, k, double)
        want = torch.topk(x.abs(), (k + 1) // 2).values[-1]
        assert _bits(got) == _bits(want) and seen == [2048, 2048, 1024]


def test_radix_rounds_plain():
    """One round by hand: the histogram counts only the prefix's elements;
    the pick keeps the highest digit reaching the rank and moves the rank
    past the elements above it."""
    x = torch.tensor([1.0, 2.0, 2.0, 3.0, -4.0, 0.0])
    prefix = torch.zeros(1, dtype=torch.int32)
    hist = T.radix_hist(x, prefix, 21, 11)
    digits = (x.abs().view(torch.int32) >> 21).tolist()
    assert hist.dtype == torch.int64 and hist.sum() == 6
    assert all(hist[d] == digits.count(d) for d in digits)
    sought = torch.tensor([3], dtype=torch.int64)
    T.radix_pick(hist, sought, prefix, 21)
    d = int(prefix) >> 21
    assert d == digits[1] and int(sought) == 3 - sum(1 for e in digits if e > d)
    prefix2 = T.radix_hist(x, prefix, 10, 11)
    assert int(prefix2.sum()) == sum(1 for e in digits if e == d)


def test_kth_magnitude_on_the_cpu_takes_topk_unmeshed():
    calls = []
    real = T.radix_select
    try:
        T.radix_select = lambda *a, **kw: calls.append(a) or real(*a, **kw)
        x = torch.from_numpy(SELECT_CASES["normal"])
        assert _bits(TC.kth_magnitude(x, 5)) == _bits(torch.topk(x.abs().reshape(-1), 5).values[-1])
        assert calls == []
    finally:
        T.radix_select = real


# ---------------------------------------------------------------------------
# refusals and the import
# ---------------------------------------------------------------------------


def _adamw_args(**over):
    n = 8
    args = dict(g=torch.zeros(n, dtype=torch.bfloat16), m=torch.zeros(n), v=torch.zeros(n),
                ref=torch.zeros(n), p=torch.zeros(n, dtype=torch.bfloat16),
                lr=torch.tensor(1e-3), c1=torch.tensor(0.1), c2=torch.tensor(0.05),
                lr_wd=torch.tensor(1e-4), scale=None)
    args.update(over)
    return args


REFUSALS = {
    "several devices": dict(m=torch.zeros(8, device="meta")),
    "a scalar on another device": dict(lr=torch.tensor(1e-3, device="meta")),
    "float16 gradient": dict(g=torch.zeros(8, dtype=torch.float16)),
    "int32 parameter": dict(p=torch.zeros(8, dtype=torch.int32)),
    "bf16 moment": dict(v=torch.zeros(8, dtype=torch.bfloat16)),
    "non-contiguous view": dict(m=torch.zeros(16)[::2]),
    "another shape": dict(v=torch.zeros(9)),
    "two-element scalar": dict(c1=torch.zeros(2)),
    "float64 scale": dict(scale=torch.tensor(0.5, dtype=torch.float64)),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_adamw_update_refuses(what):
    with pytest.raises(ValueError):
        T.adamw_update(**_adamw_args(**REFUSALS[what]), b1=0.9, b2=0.95, eps=1e-8)


def _i32(*shape, dtype=torch.int32, device="cpu"):
    return torch.zeros(*shape, dtype=dtype, device=device)


RADIX_REFUSALS = {
    "hist: non-contiguous": lambda: T.radix_hist(torch.zeros(16)[::2], _i32(1), 21, 11),
    "hist: float64 values": lambda: T.radix_hist(torch.zeros(8, dtype=torch.float64), _i32(1),
                                                 21, 11),
    "hist: 2-D values": lambda: T.radix_hist(torch.zeros(2, 4), _i32(1), 21, 11),
    "hist: int64 prefix": lambda: T.radix_hist(torch.zeros(8), _i32(1, dtype=torch.int64), 21, 11),
    "hist: a 12-bit digit": lambda: T.radix_hist(torch.zeros(8), _i32(1), 20, 12),
    "hist: past bit 31": lambda: T.radix_hist(torch.zeros(8), _i32(1), 22, 11),
    "hist: several devices": lambda: T.radix_hist(torch.zeros(8), _i32(1, device="meta"), 21, 11),
    "pick: int32 histogram": lambda: T.radix_pick(_i32(2048), _i32(1, dtype=torch.int64), _i32(1),
                                                  21),
    "pick: 1000 bins": lambda: T.radix_pick(_i32(1000, dtype=torch.int64),
                                            _i32(1, dtype=torch.int64), _i32(1), 0),
    "pick: int32 sought": lambda: T.radix_pick(_i32(2048, dtype=torch.int64), _i32(1), _i32(1),
                                               21),
}


@pytest.mark.parametrize("what", sorted(RADIX_REFUSALS))
def test_radix_wrappers_refuse(what):
    with pytest.raises(ValueError):
        RADIX_REFUSALS[what]()


def test_train_kernels_import_and_run_plain_without_nvcc(tmp_path):
    """With no ``nvcc`` on ``PATH`` or under ``CUDA_HOME``, the module
    imports and its plain versions run; nothing is built (the build
    raises, naming the compiler, only when a kernel is asked for)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import build, train as T\n"
        "x = torch.arange(10, dtype=torch.float32)\n"
        "assert float(T.radix_select(x, 3)) == 7.0\n"
        "try:\n"
        "    build.nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', 'nvcc not found' in str(e))\n"
        "print(sorted(T.launches.items()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "no nvcc: True", "[('adamw_update', 0), ('radix_hist', 0), ('radix_pick', 0)]"]
