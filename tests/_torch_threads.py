"""The port's test files run torch on one intra-op thread: import
``_one_thread`` into a test module (``from _torch_threads import
_one_thread  # noqa: F401``) and its module-scoped autouse fixture sets
it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small ops, which several
    threads a process slow down many times over when the suite runs its
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
