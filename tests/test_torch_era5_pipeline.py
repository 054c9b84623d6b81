"""The port's input pipeline: `data.prefetch` (a background thread copying
batches to the device) and `data.workers` (windows packed in spawned
processes).

The contracts: the prefetcher keeps the order, surfaces an exception at
its step and closes promptly; the worker pool's batch stream is bitwise
the in-process `sources.batch_iterator`'s (rows and looping included) and
the JAX package's `batch_iterator` on the same ERA5 corpus.
"""

import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gencast_tpu.data import registry as jax_registry
from gencast_tpu.data import sources as jax_sources
from gencast_tpu_torch.data import prefetch, registry, sources
from gencast_tpu_torch.data.workers import ParallelBatchIterator
from gencast_tpu_torch.tools import synth_era5
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TASK = registry.GENCAST_TASK


class _BoomSource(sources.SyntheticSource):

  def sample(self, index, num_target_frames=1):
    raise RuntimeError('disk on fire')


# Module-level so the 'spawn' children can unpickle it by reference.
BOOM_FACTORY = functools.partial(_BoomSource, TASK, np.linspace(-88, 88, 4),
                                 np.linspace(0, 350, 8), num_times=12, seed=7)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  """An npz ERA5 directory at 10 degrees, two months of 6 frames."""
  root = str(tmp_path_factory.mktemp('pipeline_era5'))
  synth_era5.synthesize(root, resolution_deg=10.0, months=('202001',
                                                           '202002'),
                        steps_per_month=6, seed=2, layout='npz')
  return root


def _assert_batches_equal(got, want):
  assert len(got) == len(want) > 0
  for b_got, b_want in zip(got, want):
    assert sorted(b_got) == sorted(b_want)
    for k in b_want:
      np.testing.assert_array_equal(b_got[k], b_want[k])


def test_prefetch_keeps_the_order_and_applies_the_transform():
  with prefetch.DevicePrefetcher(iter(range(20)), transform=lambda x: 2 * x,
                                 buffer_size=3) as it:
    assert list(it) == [2 * x for x in range(20)]


def test_prefetch_surfaces_an_exception_at_its_step():
  def source():
    yield 0
    yield 1
    raise OSError('bad shard')

  it = prefetch.DevicePrefetcher(source(), buffer_size=2)
  assert [next(it), next(it)] == [0, 1]
  with pytest.raises(OSError, match='bad shard'):
    next(it)
  with pytest.raises(StopIteration):  # closed by the error
    next(it)


def test_prefetch_close_stops_a_blocked_producer_promptly():
  produced = []

  def endless():
    i = 0
    while True:
      produced.append(i)
      yield i
      i += 1

  it = prefetch.DevicePrefetcher(endless(), buffer_size=2)
  assert next(it) == 0
  time.sleep(0.2)  # the producer fills the buffer and blocks
  t0 = time.perf_counter()
  it.close()
  assert time.perf_counter() - t0 < 2.0
  assert not any(t.name == 'gencast-prefetch' and t.is_alive()
                 for t in threading.enumerate())
  assert len(produced) <= 5
  with pytest.raises(ValueError):
    prefetch.DevicePrefetcher(iter([]), buffer_size=0)


def test_card_copy_on_the_cpu_gives_the_arrays_as_tensors():
  """On the CPU there is no pinning and nothing in flight: `arrived` gets
  the tensors themselves, equal to the arrays."""
  copy = prefetch.CardCopy(torch.device('cpu'))
  assert copy.stream is None
  batch = {'inputs': np.arange(6, dtype=np.float32).reshape(2, 3)}
  got = prefetch.arrived(copy(batch))
  assert got['inputs'].device.type == 'cpu'
  np.testing.assert_array_equal(got['inputs'].numpy(), batch['inputs'])
  with prefetch.DevicePrefetcher(iter([batch, batch]), transform=copy) as it:
    assert [prefetch.arrived(b)['inputs'].sum().item() for b in it] == [15, 15]


def test_workers_stream_equals_the_in_process_and_jax_streams(corpus):
  """Shuffled, one pass: the worker pool's batches equal the port's
  in-process iterator's and the JAX package's on the same corpus."""
  factory = functools.partial(sources.Era5NpzSource, corpus, TASK)
  ref = list(sources.batch_iterator(factory(), 2, seed=3, loop=False))
  jax_ref = list(jax_sources.batch_iterator(
      jax_sources.Era5NpzSource(corpus, jax_registry.GENCAST_TASK), 2,
      seed=3, loop=False))
  with ParallelBatchIterator(factory, 2, num_workers=2, seed=3,
                             loop=False) as it:
    got = list(it)
  _assert_batches_equal(ref, jax_ref)
  _assert_batches_equal(got, ref)
  assert len(got) == (12 - 2) // 2


def test_workers_rows_and_looping_match(corpus):
  """Rows slicing and looping past an epoch (reshuffles) through a worker,
  behind the prefetch thread: the in-process stream, bitwise."""
  factory = functools.partial(sources.Era5NpzSource, corpus, TASK)
  ref_it = sources.batch_iterator(factory(), 4, seed=0, rows=[1, 3])
  ref = [next(ref_it) for _ in range(5)]  # > one epoch of 10 // 4 = 2
  with ParallelBatchIterator(factory, 4, num_workers=1, seed=0,
                             rows=[1, 3]) as packer, \
      prefetch.DevicePrefetcher(packer, buffer_size=2) as it:
    got = [next(it) for _ in range(5)]
  _assert_batches_equal(got, ref)
  assert got[0]['inputs'].shape[0] == 2


def test_worker_exception_surfaces_and_closes():
  with pytest.raises(RuntimeError, match='disk on fire'):
    with ParallelBatchIterator(BOOM_FACTORY, 1, num_workers=1) as it:
      next(it)
  with pytest.raises(ValueError):
    ParallelBatchIterator(BOOM_FACTORY, 1, num_workers=0)


def test_xarray_bridge_says_what_it_needs(monkeypatch):
  """xarray is an optional dependency, imported when a conversion runs;
  without it (as here and on the card's machine) the bridge names the
  package and the packed-array API."""
  from gencast_tpu_torch.data import layout, xarray_bridge
  monkeypatch.setitem(sys.modules, 'xarray', None)
  lay = layout.build_layout(TASK.target_variables, TASK.pressure_levels, 1)
  with pytest.raises(ImportError, match='requires xarray') as err:
    xarray_bridge.packed_to_dataset(np.zeros((1, 2, 3, lay.num_channels)),
                                    lay, np.zeros(2), np.zeros(3))
  assert 'gencast_tpu_torch.data.layout' in str(err.value)
  with pytest.raises(ImportError, match='requires xarray'):
    xarray_bridge.dataset_to_packed(None, lay)
