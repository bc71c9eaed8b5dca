"""The port's CPU tests run on one torch thread.

Their tensors are tiny, and the pytest-xdist workers share the machine's
cores: torch's multi-threaded CPU kernels then oversubscribe them, and a
test can take ten times as long as it does alone.  Every
``tests/test_torch_*.py`` module imports ``one_torch_thread`` from here, a
module-scoped autouse fixture that sets one thread for the module's tests
and restores the previous count after them.  The JAX package's tests are
left as they are.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1


def test_the_count_is_restored_after_a_module():
    gen = one_torch_thread.__wrapped__()
    before = torch.get_num_threads()
    next(gen)
    assert torch.get_num_threads() == 1
    with pytest.raises(StopIteration):
        next(gen)
    assert torch.get_num_threads() == before
