"""The port's observability utilities, tracing tools, ERA5 validator and
launch scripts, on the CPU: `utils.profile_trace`, `utils.sampler_fixture`
against `model.sample` on the same generator, `tools.trace_qdeg.parse` on a
written trace,
`tools.check_era5` against the JAX package's `tools/check_era5.py` on a
corpus of the port's `synth_era5` and corrupted copies of it, and every
flag of `gencast_tpu_torch/scripts/*.sh` parsed by the port's CLIs.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import re
import shlex
import shutil

import numpy as np
import pytest
import torch

from gencast_tpu_torch import configs, utils
from gencast_tpu_torch.models import casting
from gencast_tpu_torch.tools import trace_qdeg
from gencast_tpu_torch.training import evaluate, profile_step, train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, 'gencast_tpu_torch', 'scripts')


def test_profile_trace_none_is_a_no_op(tmp_path):
  with utils.profile_trace(None) as prof:
    torch.ones(2) @ torch.ones(2)
  assert prof is None
  assert not os.listdir(tmp_path)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
  out = str(tmp_path / 'trace')
  with utils.profile_trace(out) as prof:
    torch.ones(8, 8) @ torch.ones(8, 8)
  assert prof is not None
  with open(os.path.join(out, utils.TRACE_FILE)) as f:
    events = json.load(f)['traceEvents']
  assert any(e.get('name') == 'aten::mm' for e in events)
  # On the CPU the trace holds no device kernel for parse to count.
  with pytest.raises(SystemExit, match='no device kernel'):
    trace_qdeg.parse(out)


@pytest.mark.parametrize('bf16', [False, True], ids=['float32', 'bf16'])
def test_sampler_fixture_is_model_sample(bf16):
  """The fixture's model (bf16-wrapped where the spec is) and inputs, one
  forecast step: the sum of `model.sample` of an independently built model
  on the same generator, bitwise."""
  spec = dataclasses.replace(configs.TINY, num_noise_levels=3,
                             cast_bf16=bf16)
  fx = utils.sampler_fixture(spec, device='cpu', rngs_seed=4)
  assert isinstance(fx.model, casting.Bfloat16Cast) == bf16
  got = fx.sample(fx.inputs, fx.forcings, fx.generator(2))

  model, statics = configs.build_gencast(spec, seed=4, device='cpu')
  if bf16:
    model = casting.Bfloat16Cast(model)
  d = fx.denoiser
  g = torch.Generator().manual_seed(0)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.randn(grid + (d.input_layout.num_channels,), generator=g)
  forcings = torch.randn(grid + (d.forcing_layout.num_channels,),
                         generator=g)
  want = model.sample(inputs, forcings, torch.Generator().manual_seed(2))
  assert torch.equal(fx.inputs, inputs) and torch.equal(fx.forcings,
                                                        forcings)
  assert got.shape == () and torch.isfinite(got)
  assert torch.equal(got, want.sum())


def _event(name, cat, dur, ph='X'):
  return {'ph': ph, 'cat': cat, 'name': name, 'dur': dur, 'ts': 0,
          'pid': 0, 'tid': 0}


def test_trace_qdeg_parse_groups_by_family(tmp_path, capsys):
  events = (
      [_event('void sparse_attention_fwd_mma_kernel<128>(...)', 'kernel',
              500.0)] * 3
      + [_event('segment_sum_kernel', 'kernel', 50.0)] * 2
      + [_event('ln_film_bwd_kernel<__nv_bfloat16>', 'kernel', 200.0),
         _event('nvjet_tst_128x64_64x4_1x2_h_bz_TNN', 'kernel', 400.0),
         _event('void at::native::elementwise_kernel<128, 4>', 'kernel',
                10.0),
         _event('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 5.0),
         _event('some_other_kernel', 'kernel', 1.0),
         # Host events and device-track annotations do not count.
         _event('aten::mm', 'cpu_op', 9e6),
         _event('Optimizer.step#AdamW.step', 'gpu_user_annotation', 9e6),
         _event('segment_sum_kernel', 'kernel', 9e6, ph='i')])
  out = str(tmp_path)
  with open(os.path.join(out, utils.TRACE_FILE), 'w') as f:
    json.dump({'traceEvents': events}, f)
  got = trace_qdeg.parse(out, top=3)
  fam = got['families']
  assert fam['A'] == [1.5, 3] and fam['B'] == [0.1, 2]
  assert fam['E'] == [0.2, 1] and fam['cuBLAS matmuls'] == [0.4, 1]
  assert fam['elementwise'] == [0.01, 1]
  assert fam['other'] == [pytest.approx(0.006), 2]
  assert got['total_ms'] == pytest.approx(2.216)
  assert sum(n for _, n in got['kernels'].values()) == 10
  printed = capsys.readouterr().out
  assert '[profile]   A: 1.500 ms, 67.7%, 3' in printed
  assert len(re.findall(r'^\[profile\]\s+[0-9.]+ ms, \d+, ', printed,
                        re.M)) == 3


@pytest.mark.parametrize('tool, argv, preset, mode', [
    ('trace_sampler', [], '1deg', 'sample'),
    ('trace_sampler', ['nano'], 'nano', 'sample'),
    ('trace_qdeg', [], '0.25deg', 'train'),
    ('trace_qdeg', ['1deg'], '1deg', 'train'),
])
def test_trace_tools_are_one_profile_step_run(tool, argv, preset, mode,
                                              tmp_path, monkeypatch, capsys):
  """Each tracing tool is one `profile_step` run of one step of its preset
  and mode, its trace written into the tool's directory, then `parse` of
  that trace."""
  run_main = profile_step.main
  calls = []

  def fake_main(args):
    calls.append(args)
    path = args[args.index('--trace') + 1]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
      json.dump({'traceEvents': [_event('segment_sum_kernel', 'kernel',
                                        50.0)]}, f)

  monkeypatch.setattr(profile_step, 'main', fake_main)
  out = str(tmp_path / 'trace')
  importlib.import_module(f'gencast_tpu_torch.tools.{tool}').main(
      [out] + argv)
  assert calls == [['--preset', preset, '--mode', mode, '--steps', '1',
                    '--trace', os.path.join(out, utils.TRACE_FILE)]]
  assert '[profile]   B: 0.050 ms, 100.0%, 1' in capsys.readouterr().out
  # The arguments parse; the run itself needs the card.
  if not torch.cuda.is_available():
    with pytest.raises(SystemExit, match='needs a CUDA card'):
      run_main(calls[0])


@pytest.fixture(scope='module')
def era5_corpus(tmp_path_factory):
  pytest.importorskip('h5py')
  from gencast_tpu_torch.tools import synth_era5
  root = str(tmp_path_factory.mktemp('era5'))
  synth_era5.synthesize(root, resolution_deg=10.0, months=('202001',),
                        steps_per_month=4, seed=5)
  return root


def _jax_check_era5():
  spec = importlib.util.spec_from_file_location(
      'jax_check_era5', os.path.join(ROOT, 'tools', 'check_era5.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _corrupted(root, tmp_path, edit) -> str:
  import h5py
  bad = str(tmp_path / 'bad')
  shutil.copytree(root, bad)
  path = glob.glob(os.path.join(bad, 'era5_pressure_levels_*.nc'))[0]
  with h5py.File(path, 'a') as f:
    edit(f)
  return bad


def _swap_latitudes(f):
  lat = f['latitude'][...]
  lat[0], lat[1] = lat[1], lat[0]
  f['latitude'][...] = lat


def _nan_temperature(f):
  del f['t'].attrs['scale_factor']
  f['t'].attrs['scale_factor'] = np.float64(np.nan)


@pytest.mark.parametrize('case', ['clean', 'strict', 'missing_level',
                                  'bad_latitude', 'nan_packing'])
def test_check_era5_matches_the_jax_tool(era5_corpus, tmp_path, case):
  """The port's validator passes the port's corpus and fails its
  corrupted copies with the JAX tool's exit codes (both read the same
  files)."""
  from gencast_tpu_torch.tools import check_era5
  root = era5_corpus
  extra = {'strict': ['--strict'], 'missing_level': ['--levels', '725']
           }.get(case, ['--levels', '500', '850'])
  if case == 'bad_latitude':
    root = _corrupted(root, tmp_path, _swap_latitudes)
  elif case == 'nan_packing':
    root = _corrupted(root, tmp_path, _nan_temperature)
  argv = [root, '--resolution', '10'] + extra
  got = check_era5.main(argv)
  assert got == _jax_check_era5().main(argv)
  assert got == (0 if case in ('clean', 'strict') else 1)


def _script_argv(name):
  """The module and the arguments of the `python -m` command of script
  `name`, shell variables replaced by '1' and the trailing "$@" dropped."""
  with open(os.path.join(SCRIPTS, name)) as f:
    text = f.read()
  command = re.search(r'^(?:exec )?python -m (?:.*\\\n)*.*$', text,
                      re.M).group(0).replace('\\\n', ' ')
  words = shlex.split(re.sub(r'\$\{?[A-Za-z_]\w*\}?', '1', command))
  assert words[-1] == '$@', f'{name}: "$@" must come last'
  words = words[words.index('python'):]
  return words[2], words[3:-1]


@pytest.mark.parametrize('name', ['train_nano.sh', 'evaluate.sh',
                                  'forecast_quarterdeg.sh'])
def test_script_flags_parse(name):
  module, argv = _script_argv(name)
  cli = {'gencast_tpu_torch.training.train': train,
         'gencast_tpu_torch.training.evaluate': evaluate}[module]
  args = cli.parse_args(argv)
  assert args.clean_sst_nans
  assert '--no_overlap_offload' not in argv
  if name == 'forecast_quarterdeg.sh':
    assert args.preset == '0.25deg' and args.chunk_size == 1
  text = open(os.path.join(SCRIPTS, name)).read()
  assert 'TPU' not in text.replace('scripts/train_nano_tpu.sh', '').replace(
      'scripts/evaluate_tpu.sh', '')
