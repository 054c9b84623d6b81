"""No module of the benchmark imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the program either: top-level import
names compared whole (`gencast_tpu_torch` is not `gencast_tpu`)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BENCH = os.path.join(ROOT, 'perfbench')
REFUSED = {'jax', 'jaxlib', 'flax', 'gencast_tpu'}


def modules():
  for dirpath, _, files in os.walk(BENCH):
    for f in files:
      if f.endswith('.py'):
        yield os.path.join(dirpath, f)


def imported(path):
  """Top-level names of every import in the file, at any depth."""
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        yield a.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module.split('.')[0]


def test_finds_the_modules():
  found = list(modules())
  assert any(p.endswith(os.path.join('perfbench', 'run.py')) for p in found)
  assert any(os.sep + 'reference' + os.sep in p for p in found)


@pytest.mark.parametrize('path', sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
  assert not set(imported(path)) & REFUSED


@pytest.mark.parametrize(
    'path', sorted(p for p in modules()
                   if os.sep + 'reference' + os.sep in p),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_takes_nothing_of_the_program(path):
  assert 'gencast_tpu_torch' not in set(imported(path))


def test_whole_names_are_compared():
  # The port's name begins with the JAX package's: it is not refused.
  assert 'gencast_tpu_torch'.split('.')[0] not in REFUSED
