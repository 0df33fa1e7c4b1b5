"""One intra-op thread for the port's CPU tests.

The port's tests run at toy sizes (n = 4 to 8, smoke LMs), where torch's
intra-op threads only add barriers, and their waiting threads take CPU
from the other test workers (``pytest -n``) and from the JAX package's
computations in the same process: one campaign fixture used 120 s of CPU
for 17 s of wall on 8 threads, 18 s on one.  A test module imports
``one_thread`` to run on one thread; the count is restored after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
