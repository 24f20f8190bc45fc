"""The harness's tests run each cell small on the CPU, on one thread: where
the suite runs on several workers at once, a pool of threads each would
only contend for the cores, and the timed windows of these runs would take
the cost."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
