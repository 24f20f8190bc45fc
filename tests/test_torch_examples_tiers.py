"""The observability and streaming walkthroughs among the port's examples
against the JAX package's (see ``test_torch_examples.py``): both run on one
virtual µs clock, so every number they print is compared."""
import pytest

pytest.importorskip("torch")

from test_torch_examples_common import normalize, run_pair  # noqa: E402


@pytest.mark.parametrize("name", ["observability_demo", "streaming_demo"])
def test_example_prints_what_the_reference_prints(name):
    port, ref = run_pair(name)
    assert normalize(port) == normalize(ref)
    assert port.splitlines()[0].startswith("[device] cpu")
