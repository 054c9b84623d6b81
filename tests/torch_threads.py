"""One torch CPU thread per test module of the port.

The test run spreads the files over several worker processes on one host;
torch's default of a thread per core in each of them oversubscribes the
cores, and the port's small eager ops then wait on each other's threads
(a TINY evaluate run took minutes instead of seconds). Modules import the
autouse fixture below; it restores the previous count when they end.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)
