"""One intra-op torch thread while a port test file runs.

The tier-1 suite runs six processes on eight cores. Torch's default of one
intra-op thread a core oversubscribes them about six times over, and the
port's small CPU shapes run no faster on eight threads than on one
(`test_torch_executor_loop.py` alone: 40 s on eight, 33 s on one). A test
file takes the fixture by importing it:

    from test_torch_threads import one_thread  # noqa: F401

`test_torch_distributed.py` and `test_torch_optim_registry.py` keep the
default: their float32 bounds were set on it."""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_thread_while_the_module_runs():
    assert torch.get_num_threads() == 1
