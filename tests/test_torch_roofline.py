"""The port's roofline (``repro_torch.roofline``): the H100 constants, the
aten-op cost model against the JAX package's HLO cost model, and the
roofline terms of one call.

The FLOP count is held to the reference's exactly: a reduced dense
architecture's float32 ``prefill`` (stablelm-3b) counted over the port's
aten products equals ``repro.roofline.hlo_parse``'s count over the
reference's compiled ``prefill`` on the same config, op for op
(its ``dot``s, summed through the scanned layers' trip counts).
"""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.roofline import hw, op_cost  # noqa: E402
from repro_torch.roofline.analysis import Roofline, analyze  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_h100_constants():
    assert hw.HBM_BW == 3.35e12
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.LANE_INSTR_S == 33.5e12
    assert 18 * hw.NVLINK_LINK_BW == 450e9  # 18 links, each way
    assert hw.BYTES_PER_DTYPE[torch.bfloat16] == 2 and hw.BYTES_PER_DTYPE[torch.int64] == 8
    assert all(isinstance(k, torch.dtype) for k in hw.BYTES_PER_DTYPE)


def test_chip_smoke_keeps_no_copy_of_the_constants():
    source = (ROOT / "chip_smoke.py").read_text()
    assigned = {t.id for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not assigned & {"HBM_BYTES_S", "LANE_INSTR_S", "BF16_FLOP_S", "FUNCTIONS"}
    assert "3.35e12" not in source and "989e12" not in source
    assert "def sass_sizes" not in source


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "baddbmm", "matmul", "einsum", "linear"])
def test_product_flops(op):
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(6, 5, generator=g), torch.randn(5, 7, generator=g)
    A, B = torch.randn(3, 6, 5, generator=g), torch.randn(3, 5, 7, generator=g)
    calls = {
        "mm": (lambda: a @ b, 2 * 6 * 7 * 5),
        "bmm": (lambda: torch.bmm(A, B), 2 * 3 * 6 * 7 * 5),
        "addmm": (lambda: torch.addmm(torch.zeros(7), a, b), 2 * 6 * 7 * 5),
        "baddbmm": (lambda: torch.baddbmm(torch.zeros(3, 6, 7), A, B), 2 * 3 * 6 * 7 * 5),
        "matmul": (lambda: torch.matmul(A, b), 2 * 3 * 6 * 7 * 5),
        "einsum": (lambda: torch.einsum("bij,bjk->bik", A, B), 2 * 3 * 6 * 7 * 5),
        "linear": (lambda: torch.nn.functional.linear(A, b.T), 2 * 3 * 6 * 7 * 5),
    }
    fn, want = calls[op]
    _, cost = op_cost.count(fn)
    assert cost.flops == want


def test_byte_rules():
    x = torch.zeros(4, 8)
    _, cost = op_cost.count(lambda: x.view(32).expand(2, 32))
    assert cost.bytes == 0  # views move nothing
    _, cost = op_cost.count(lambda: x + 1)
    assert cost.bytes == 2 * 4 * 8 * 4  # elementwise: one write, one read downstream
    _, cost = op_cost.count(lambda: x[1:3].copy_(torch.ones(2, 8, dtype=torch.bfloat16)))
    assert cost.by_op["aten.copy_.default"][2] == 2 * 2 * 8 * 2  # the update's bytes
    _, cost = op_cost.count(lambda: x.sum(0))
    assert cost.bytes == 2 * 8 * 4 and cost.flops == 0
    assert cost.coll_bytes == 0 and cost.coll_by_kind == {}


@functools.cache
def _prefill_flops(arch: str = "stablelm-3b", batch: int = 2, prompt: int = 8, max_len: int = 12):
    jcfg, tcfg = ref_reduced_config(arch), reduced_config(arch)
    assert jcfg.dtype == tcfg.dtype == "float32"
    params = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(batch, prompt))
    tokens = tokens.astype(np.int32)
    fn = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, max_len))
    text = fn.lower(params, jnp.asarray(tokens)).compile().as_text()
    want = hlo_parse.analyze_hlo_text(text)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    _, got = op_cost.count(TM.prefill, tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, max_len)
    return text, want, got


def test_prefill_flops_equal_the_reference_hlo_count():
    _, want, got = _prefill_flops()
    assert want.flops > 0
    assert got.flops == want.flops
    # only products carry FLOPs
    assert {name for name, (_, flops, _) in got.by_op.items() if flops} <= set(op_cost.PRODUCTS)


def test_prefill_flops_agree_op_by_op():
    """The reference's dots and the port's products, each multiset of
    per-call FLOPs scaled by the times it runs, agree: the same products,
    not just the same total."""
    text, _, got = _prefill_flops()
    comps, entry = hlo_parse.parse_module(text)
    per_call = {}
    for comp in comps.values():
        for op in comp.ops:
            if op.kind == "dot":
                per_call.setdefault(comp.name, []).append(hlo_parse._dot_flops(op, comp))
    layers = ref_reduced_config("stablelm-3b").num_layers
    # the scanned layer body runs once per layer, the entry once
    ref = sorted(f for name, fl in per_call.items() for f in fl * (1 if name == entry else layers))
    port = []

    def collect(fn, *args):
        mode = _PerCall()
        with mode:
            fn(*args)
        return mode.flops

    class _PerCall(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flops, _ = op_cost.op_cost(str(func), args, kwargs or {}, out)
            if flops:
                self.flops.append(flops)
            return out

    tcfg = reduced_config("stablelm-3b")
    params = jax.jit(functools.partial(JM.init_params, cfg=ref_reduced_config("stablelm-3b")))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, 8)).astype(np.int32))
    port = sorted(collect(TM.prefill, tparams, {"tokens": tokens}, tcfg, 12))
    assert port == ref


def test_analyze_terms():
    a, b = torch.randn(64, 128), torch.randn(128, 128)
    roof = analyze(lambda: (a @ b) @ b, model_flops_total=2 * 64 * 128 * 128 * 2)
    assert isinstance(roof, Roofline)
    assert roof.flops == roof.raw_flops == 2 * 64 * 128 * 128 * 2
    assert roof.useful_ratio == 1.0
    assert roof.coll_bytes == roof.collective_s == 0 and roof.collectives == {}
    assert roof.compute_s == roof.flops / hw.PEAK_FLOPS_BF16
    assert roof.memory_s == roof.hbm_bytes / hw.HBM_BW
    assert roof.dominant == "memory"  # 64 rows: too few products per byte
    assert set(roof.row()) == set(Roofline.__dataclass_fields__)


def test_analyze_counts_the_backward():
    w = torch.randn(32, 16, requires_grad=True)
    x = torch.randn(8, 32)

    def step():
        (x @ w).square().sum().backward()

    roof = analyze(step)
    # forward 2·8·16·32, then the weight's gradient x^T·g of the same size
    assert roof.flops == 2 * (2 * 8 * 16 * 32)
