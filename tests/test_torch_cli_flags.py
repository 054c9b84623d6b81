"""The training CLI knows every flag of the reference's
(`gencast_tpu.training.train.parse_args`): each parses with the reference's
default, `--ar_steps K` on a GenCast run is the reference's no-op, and the
flags of paths not ported are refused by name, with the ROADMAP.md item
that brings them or as TPU-only, never as "unrecognized arguments".
"""

import pytest

from gencast_tpu.training import train as jax_train
from gencast_tpu_torch.training import train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# flag -> (a value that asks for the feature, what the refusal names; None
# where the flag is accepted).
FLAGS = {
    'ar_steps': (['2'], None),
    'task': (['graphcast_37'], 'GraphCast'),
    'remat_group': (['4'], 'GraphCast'),
    'functional_step': ([], 'not ported: TPU-only'),
    'pool_size': (['8'], 'Host launches'),
    'profile_dir': (['traces'], 'CLIs and data'),
    'dp': (['2'], 'Parallelism'),
    'mp': (['2'], 'Parallelism'),
    'multihost': ([], 'Parallelism'),
    'coordinator': (['localhost:1234'], 'Parallelism'),
    'process_id': (['0'], 'Parallelism'),
    'num_processes': (['2'], 'Parallelism'),
    'cpu': (['8'], 'not ported: TPU-only'),
}


@pytest.mark.parametrize('flag', sorted(FLAGS))
def test_reference_flag_parses_or_is_refused_by_name(flag, capsys):
  value, refusal = FLAGS[flag]
  # Left alone, the flag has the reference's default and asks for nothing.
  default = getattr(train.parse_args(['--preset', 'tiny']), flag)
  assert default == getattr(jax_train.parse_args(['--preset', 'tiny']), flag)
  argv = ['--preset', 'tiny', f'--{flag}'] + value
  if refusal is None:
    assert getattr(train.parse_args(argv), flag) == int(value[0])
    return
  with pytest.raises(SystemExit):
    train.parse_args(argv)
  err = capsys.readouterr().err
  assert 'unrecognized arguments' not in err
  assert f'--{flag}' in err and refusal in err
  if 'TPU-only' not in refusal:
    assert 'ROADMAP.md, "Still to port"' in err


def test_port_parser_knows_every_reference_flag():
  """No flag of the reference's parser is unknown to the port's: all of
  them at their defaults parse."""
  reference = vars(jax_train.parse_args([]))
  port = vars(train.parse_args([]))
  assert set(reference) <= set(port), set(reference) - set(port)
