"""The port test files' shared fixture: ``from _torch_threads import
_one_torch_thread`` in a test module makes it autouse there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny CPU ops on one thread: the suite runs several test
    processes at once, and spinning thread pools then cost more than the
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
