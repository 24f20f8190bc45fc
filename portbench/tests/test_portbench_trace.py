"""The traced stretch's reduction: the port's kernels found from its own
sources, attributed to the logged calls in order, and a timeline that
disagrees with the launch counters reported, not passed over.
"""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness.trace import WINDOW, kernel_name, port_kernels, reduce  # noqa: E402

KERNELS = frozenset({"route_kernel", "resolve_kernel"})


def test_the_port_declares_the_kernels_its_cells_launch():
    names = port_kernels(ROOT / "src" / "repro_torch")
    assert {"route_kernel", "resolve_kernel", "route_load_kernel", "adamw_kernel"} <= names


def test_a_kernel_is_found_in_cuda_and_triton_sources(tmp_path):
    (tmp_path / "a.cu").write_text("template <class E>\n__global__ void __launch_bounds__(256)\n"
                                   "fused_kernel(int* out) {}\n__global__ void plain(int n) {}\n")
    (tmp_path / "b.py").write_text("import triton\n@triton.jit\n@other\ndef tiled_kernel(x):\n"
                                   "    pass\ndef helper():\n    pass\n")
    assert port_kernels(tmp_path) == {"fused_kernel", "plain", "tiled_kernel"}


@pytest.mark.parametrize("name, want", [
    ("void routing::route_kernel<routing::Binomial, routing::KeySource>(routing::KeySource, int)",
     "route_kernel"),
    ("void (anonymous namespace)::resolve_kernel(unsigned int const*, int)", "resolve_kernel"),
    ("tiled_kernel", "tiled_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "DtoH"),
])
def test_kernel_names_lose_types_namespaces_and_templates(name, want):
    assert kernel_name(name) == want


def _timeline(kernels):
    events = [(WINDOW, False, 0.0, 1000.0), ("Memcpy HtoD (Pageable -> Device)", True, 1.0, 2.0)]
    return events + [(n, True, a, b) for n, a, b in kernels]


def test_kernels_are_attributed_to_the_logged_calls_in_order():
    events = _timeline([("void routing::route_kernel<B, F>(F)", 10.0, 30.0),
                        ("void routing::resolve_kernel(int)", 30.0, 40.0),
                        ("void routing::route_kernel<B, F>(F)", 50.0, 60.0),
                        ("void routing::resolve_kernel(int)", 60.0, 100.0)])
    p = reduce(events, [("call", 2), ("replan", 2)], KERNELS)
    assert p.unmatched == 0 and p.counts == {"call": 1, "replan": 1}
    assert p.kernel_s == pytest.approx({"call": 30e-6, "replan": 50e-6})


@pytest.mark.parametrize("log", [[("call", 1)], [("call", 2), ("call", 2)]])
def test_a_timeline_that_disagrees_with_the_counters_is_reported(log):
    events = _timeline([("void routing::route_kernel<B, F>(F)", 10.0, 30.0),
                        ("void renamed_kernel(int)", 30.0, 40.0),
                        ("void routing::resolve_kernel(int)", 50.0, 60.0)])
    p = reduce(events, log, KERNELS)
    assert p.unmatched == abs(2 - sum(n for _, n in log)) and p.unmatched > 0
    assert p.kernel_s is None
