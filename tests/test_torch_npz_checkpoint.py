"""The port's typed npz serializer (`gencast_tpu_torch.training.
npz_checkpoint`) against the JAX package's: the JAX test's cases on the
port's copy, files either package writes read back equal through the
other, and the same npz keys from both."""

import dataclasses
import io
from typing import Dict, Optional, Tuple

import numpy as np
import pytest

from gencast_tpu.training import npz_checkpoint as jax_ckpt
from gencast_tpu_torch.training import npz_checkpoint as ckpt
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@dataclasses.dataclass
class Inner:
  a: np.ndarray
  b: float
  name: str


@dataclasses.dataclass
class Outer:
  inner: Inner
  maybe: Optional[Inner]
  params: Dict[str, np.ndarray]
  levels: Tuple[int, ...]
  flag: bool


def _outer(maybe=None):
  return Outer(
      inner=Inner(a=np.arange(6).reshape(2, 3).astype(np.float32),
                  b=2.5, name='hello'),
      maybe=maybe,
      params={'w': np.ones((3,)), 'nested': np.zeros((2, 2))},
      levels=(50, 100, 850),
      flag=True)


def _untyped():
  return {'x': np.arange(4), 'sub': {'y': np.float32(1.5)},
          'lst': [np.ones(2), np.zeros(3)], 'tup': (np.int32(7), 'word'),
          'none': None}


def _dumped(module, tree) -> io.BytesIO:
  buf = io.BytesIO()
  module.dump(buf, tree)
  buf.seek(0)
  return buf


def _assert_trees_equal(a, b):
  """Equal structure, types and values (arrays bitwise, dtypes too)."""
  assert type(a) is type(b), (type(a), type(b))
  if dataclasses.is_dataclass(a):
    for f in dataclasses.fields(a):
      _assert_trees_equal(getattr(a, f.name), getattr(b, f.name))
  elif isinstance(a, dict):
    assert list(a) == list(b)
    for k in a:
      _assert_trees_equal(a[k], b[k])
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b)
    for x, y in zip(a, b):
      _assert_trees_equal(x, y)
  elif isinstance(a, np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
  else:
    assert a == b


# The JAX package's own cases (tests/test_npz_checkpoint.py), on the port.
def test_roundtrip_typed():
  tree = _outer()
  out = ckpt.load(_dumped(ckpt, tree), Outer)
  assert isinstance(out, Outer)
  np.testing.assert_array_equal(out.inner.a, tree.inner.a)
  assert out.inner.b == 2.5
  assert out.inner.name == 'hello'
  assert out.maybe is None
  np.testing.assert_array_equal(out.params['w'], tree.params['w'])
  assert out.levels == (50, 100, 850)
  assert out.flag is True


def test_roundtrip_untyped_dict():
  tree = {'x': np.arange(4), 'sub': {'y': np.float32(1.5)},
          'lst': [np.ones(2), np.zeros(3)]}
  out = ckpt.load(_dumped(ckpt, tree))
  np.testing.assert_array_equal(out['x'], tree['x'])
  np.testing.assert_array_equal(out['sub']['y'], 1.5)
  np.testing.assert_array_equal(out['lst'][0], np.ones(2))
  assert isinstance(out['lst'], list)


def test_optional_present():
  tree = Outer(inner=Inner(a=np.zeros(1), b=0.0, name='x'),
               maybe=Inner(a=np.ones(2), b=1.0, name='y'),
               params={}, levels=(1,), flag=False)
  out = ckpt.load(_dumped(ckpt, tree), Outer)
  assert out.maybe is not None and out.maybe.name == 'y'


def test_dict_key_with_separator_raises():
  with pytest.raises(ValueError, match="':'"):
    ckpt.dump(io.BytesIO(), {'a:b': np.zeros(1)})


@pytest.mark.parametrize('writer,reader', [(jax_ckpt, ckpt), (ckpt, jax_ckpt)],
                         ids=['jax_writes', 'port_writes'])
@pytest.mark.parametrize('typed', [True, False], ids=['typed', 'untyped'])
def test_files_cross_read_equal(writer, reader, typed):
  """A file either package writes reads back through the other equal to
  what the writer's own reader gives (typed: the dataclass tree, with the
  Optional present and absent; untyped: dicts, lists, tuples, None and
  strings)."""
  trees = ([_outer(), _outer(Inner(a=np.ones(2), b=1.0, name='y'))] if typed
           else [_untyped()])
  for tree in trees:
    target = (Outer,) if typed else ()
    got = reader.load(_dumped(writer, tree), *target)
    want = writer.load(_dumped(writer, tree), *target)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize('tree', [_outer(), _untyped()],
                         ids=['typed', 'untyped'])
def test_same_npz_keys_and_arrays(tree):
  """Both packages flatten a tree to the same npz entries, bitwise."""
  a = np.load(_dumped(jax_ckpt, tree))
  b = np.load(_dumped(ckpt, tree))
  assert sorted(a.files) == sorted(b.files)
  for k in a.files:
    assert a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
