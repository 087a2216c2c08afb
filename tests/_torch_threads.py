"""The port's CPU tests run with one intra-op thread: the tiny models' ops
gain nothing from more, and beside other test processes their thread
pools' waits dominate.  A test module imports the fixture to use it:

    from _torch_threads import _one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
