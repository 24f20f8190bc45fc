"""The port's AST lint (``repro_torch.analysis.lint``): the JAX package's
rule cases give the same findings (rule, line) through both lints, the
torch rules catch their own fixtures, the C entry points' host code is
scanned for synchronising runtime calls, and the port's hot-path tree
lints clean."""
import importlib

import pytest

pytest.importorskip("torch")

from repro.analysis.lint import lint_source as ref_lint_source  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.lint import lint_cuda_source, lint_paths, lint_source  # noqa: E402


def _found(findings):
    return [(f.rule, f.line) for f in findings]


# the rule cases of tests/test_certifier.py: (source, the port's hot names
# standing in for the reference's jax.jit decorator)
SHARED = {
    "host-sync-in-jit": (
        "import jax\n"
        "@jax.jit\n"
        "def route(keys):\n"
        "    n = keys.item()\n"
        "    return keys\n",
        ("route",),
    ),
    "waiver-comment": (
        "import jax\n"
        "@jax.jit\n"
        "def route(n):\n"
        "    l = (n - 1).bit_length()  # ct: host-ok — n is static\n"
        "    return l\n",
        ("route",),
    ),
    "cold-function": ("def oracle(key):\n    return int(key) & 0xFFFFFFFF\n", ()),
    "bare-wide-literal": ("def _mix_body(x):\n    return x * 0x9E3779B97F4A7C15\n", ()),
    "cast-wrapped-literal": (
        "import numpy as np\n"
        "def _mix_body(x):\n"
        "    return x * np.uint32(0x9E3779B9) + np.uint32(0xFFFFFFFF & 1)\n",
        (),
    ),
    "config-mutation": ("import jax\njax.config.update('jax_enable_x64', True)\n", ()),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rule_cases_match_the_reference(case):
    source, hot = SHARED[case]
    assert _found(lint_source(source, hot=hot)) == _found(ref_lint_source(source))


TORCH_CASES = {
    "cpu-copy": ("def _kernel_route(x):\n    return x.cpu()\n", [("host-sync", 2)]),
    "numpy": ("def route_body(x):\n    return x.numpy()\n", [("host-sync", 2)]),
    "tolist": ("def _kernel_x(x):\n    return x.tolist()\n", [("host-sync", 2)]),
    "synchronize": (
        "import torch\ndef _kernel_x(x):\n    torch.cuda.synchronize()\n    return x\n",
        [("host-sync", 3)],
    ),
    "float-of-tensor": ("def _kernel_x(x):\n    return float(x.sum())\n", [("host-sync", 2)]),
    "waived": ("def _kernel_x(x):\n    return x.cpu()  # ct: host-ok — test\n", []),
    "cold-cpu": ("def helper(x):\n    return x.cpu()\n", []),
    "literal-past-int64": ("def _kernel_x(x):\n    return x & 0xFFFFFFFFFFFFFFFF\n",
                           [("bare-int", 2)]),
    "u64-literal-in-int64": ("def _kernel_x(x):\n    return x * 0x7FFFFFFFFFFFFFFF\n", []),
    "u32-mask": ("def _kernel_x(x):\n    return (x + 0x9E3779B9) & 0xFFFFFFFF\n", []),
    "i64-wrapped": ("def _kernel_x(x):\n    return x * _i64(0x9E3779B97F4A7C15)\n", []),
    "tensor-wrapped": (
        "import torch\ndef _kernel_x(x):\n"
        "    return x ^ torch.tensor(0x9E3779B97F4A7C15 - (1 << 64), dtype=torch.int64)\n",
        [],
    ),
    "backends-flag": ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
                      [("config-mutation", 2)]),
    "default-dtype": ("import torch\ntorch.set_default_dtype(torch.float64)\n",
                      [("config-mutation", 2)]),
    "matmul-precision": ("import torch\ntorch.set_float32_matmul_precision('high')\n",
                         [("config-mutation", 2)]),
    "deterministic": ("import torch\ndef f():\n    torch.use_deterministic_algorithms(True)\n",
                      [("config-mutation", 3)]),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_rules(case):
    source, want = TORCH_CASES[case]
    assert _found(lint_source(source)) == want


def test_entry_points_are_hot_by_qualified_name():
    source = (
        "class RoutingKernels:\n"
        "    def route(self, keys):\n"
        "        return keys.cpu()\n"
        "    def helper(self, keys):\n"
        "        return keys.cpu()\n"
        "def _kernels(spec):\n"
        "    return spec.item()\n"
    )
    found = lint_source(source, module="repro_torch.kernels.fused")
    # the listed launch method and the _kernel* name (ops._kernels matches
    # it, as it would in the JAX package) are hot; the helper is not
    assert _found(found) == [("host-sync", 3), ("host-sync", 7)]
    assert _found(lint_source(source, module="elsewhere")) == [("host-sync", 7)]


def test_every_listed_entry_point_exists():
    for qualified in lint.HOT_FUNCTIONS:
        module_name, _, rest = qualified.rpartition(".")
        while module_name:
            try:
                module = importlib.import_module(module_name)
                break
            except ModuleNotFoundError:
                module_name, _, head = module_name.rpartition(".")
                rest = f"{head}.{rest}"
        obj = module
        for part in qualified[len(module_name) + 1:].split("."):
            obj = getattr(obj, part)
        assert callable(obj), qualified


CUDA = """\
extern "C" int launch(void* out, cudaStream_t s) {
  cudaMemcpyAsync(out, out, 4, cudaMemcpyDeviceToDevice, s);
  cudaMemcpy(out, out, 4, cudaMemcpyDeviceToDevice);
  // cudaDeviceSynchronize() in a comment is not a call
  cudaStreamSynchronize(s);
  cudaMalloc(&out, 4);  // ct: host-ok — test
  cudaMallocAsync(&out, 4, s);
  return cudaDeviceSynchronize();
}
"""


def test_cuda_host_code_scan():
    found = lint_cuda_source(CUDA, "k.cu")
    assert _found(found) == [("host-sync", 3), ("host-sync", 5), ("host-sync", 8)]
    assert "cudaMemcpy()" in found[0].message


def test_port_hot_paths_lint_clean():
    assert lint_paths() == []


def test_lint_scans_the_c_entry_points():
    import repro_torch
    from pathlib import Path

    root = Path(repro_torch.__file__).parent
    scanned = sorted(p.name for p in (root / "kernels").rglob("*") if p.suffix in (".cu", ".cuh"))
    assert scanned == ["routing.cu", "routing.cuh", "train.cu"]
    for name in ("routing.cu", "train.cu"):
        tree = (root / "kernels" / "csrc" / name).read_text()
        assert 'extern "C"' in tree and lint_cuda_source(tree) == []
