"""The benchmark's tests: on the CPU at a TINY configuration, and, marked
`card`, on a CUDA card at the cells' own sizes (they skip without one;
the decision is made in the `card` fixture, never while a module is
imported)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'card: needs a CUDA card; run on the chip with '
      '`python3 -m pytest perfbench/tests -m card`')


@pytest.fixture(autouse=True)
def _few_threads():
  import torch
  torch.set_num_threads(2)


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the check runs at the cell\'s own size')
  return torch.device('cuda')
