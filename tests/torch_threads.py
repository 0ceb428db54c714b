"""One torch intra-op thread while a port test module runs.

The tier-1 command runs six pytest-xdist workers, and torch's default
intra-op pool (an OpenMP thread for every core in every worker)
oversubscribes the cores: six concurrent runs of tests/test_torch_lookup.py
on an 8-core CPU took 353.6 s with the default pool and 93.7 s with one
thread each. A port test module imports this autouse fixture; the count
is restored after the module, so other modules keep their own.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
