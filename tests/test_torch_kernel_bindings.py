"""The ctypes signatures of the port's CUDA entry points against their C
declarations, the head dims the wrappers accept against those the sources
are compiled for, and the wrappers' alignment check.

The kernels compile and run only on a machine with nvcc and a card, so a
wrong arity, or a pointer declared as a 32-bit int (ctypes would cut it),
would otherwise show only there. Every `extern "C"` function of
`gencast_tpu_torch/csrc/*.cu` is read with a regular expression and held
against `cuda_lib._SIGNATURES`.
"""

import ctypes
import glob
import os
import re

import pytest

from gencast_tpu_torch.ops import banded_attention, cuda_lib, sparse_attention

_DECLARATION = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_CTYPES = {'int': ctypes.c_int, 'float': ctypes.c_float,
           'long long': ctypes.c_longlong}


def _declarations():
  """{function name: [ctypes type of each parameter]} of every extern "C"
  function in the kernels' sources."""
  found = {}
  for path in sorted(glob.glob(os.path.join(cuda_lib.CSRC_DIR, '*.cu'))):
    with open(path) as f:
      source = f.read()
    for name, params in _DECLARATION.findall(source):
      assert name not in found, f'{name} is declared twice'
      types = []
      for param in filter(None, (p.strip() for p in params.split(','))):
        if '*' in param:
          types.append(ctypes.c_void_p)
        else:
          ctype = re.sub(r'\bconst\b', '', param).rsplit(None, 1)[0].strip()
          types.append(_CTYPES[ctype])
      found[name] = types
  return found


DECLARED = _declarations()


def test_sources_declare_entry_points():
  # The regular expression still finds them: one per kernel wrapper and
  # the tile-size query.
  assert len(DECLARED) >= 10
  assert DECLARED['gt_sparse_attention_tile'] == []


@pytest.mark.parametrize('name', sorted(DECLARED))
def test_signature_matches_declaration(name):
  assert name in cuda_lib._SIGNATURES, f'{name} has no ctypes signature'
  argtypes = cuda_lib._SIGNATURES[name]
  declared = DECLARED[name]
  assert len(argtypes) == len(declared), (
      f'{name}: {len(argtypes)} ctypes arguments for {len(declared)} C '
      'parameters')
  for i, (got, want) in enumerate(zip(argtypes, declared)):
    assert got is want, f'{name}, parameter {i}: {got} for {want}'


@pytest.mark.parametrize('name', sorted(cuda_lib._SIGNATURES))
def test_signature_has_a_c_function(name):
  assert name in DECLARED, f'{name} is bound but no source declares it'


_DISPATCH_D = re.compile(
    r'cudaError_t dispatch_d\(.*?switch \(head_dim\) \{(.*?)default:', re.S)
# Each attention source and the wrapper module that launches its kernels.
_SOURCES = {'sparse_attention.cu': sparse_attention,
            'sparse_attention_bwd.cu': sparse_attention,
            'sparse_attention_dq_reduce.cu': sparse_attention,
            'banded_attention.cu': banded_attention,
            'banded_attention_bwd.cu': banded_attention}


@pytest.mark.parametrize('source', sorted(_SOURCES))
def test_wrapper_head_dims_are_the_compiled_ones(source):
  """A head dim the wrapper lets through and `dispatch_d` has no case for
  comes back as cudaErrorInvalidValue from the launch; one that is compiled
  and not let through is never reached."""
  with open(os.path.join(cuda_lib.CSRC_DIR, source)) as f:
    (cases,) = _DISPATCH_D.findall(f.read())
  compiled = tuple(int(d) for d in re.findall(r'case (\d+):', cases))
  assert compiled and compiled == tuple(_SOURCES[source]._HEAD_DIMS)


@pytest.mark.parametrize('address', [0, 16, 0x7F0000000400])
def test_aligned_addresses_pass(address):
  cuda_lib.check_aligned({'q': address, 'k': address + 32})


@pytest.mark.parametrize('address', [8, 0x7F0000000402, 0x7F0000000404])
def test_misaligned_address_raises(address):
  with pytest.raises(ValueError, match='dout'):
    cuda_lib.check_aligned({'q': 0, 'dout': address})
