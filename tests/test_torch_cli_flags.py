"""The training CLI knows every flag of the reference's
(`gencast_tpu.training.train.parse_args`): each parses with the reference's
default and, where it is ported, with the reference's meaning of a value
(GraphCast's `--task` and `--remat_group`, and the data-parallel `--dp`,
`--multihost`, `--coordinator`, `--process_id` and `--num_processes` among
them, and the model axis's `--mp`); `--ar_steps K` on a GenCast run is the
reference's no-op, and the TPU-only flags are refused by name as such,
never as "unrecognized arguments".
"""

import pytest

from gencast_tpu.training import train as jax_train
from gencast_tpu_torch.training import train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# flag -> (a value that asks for the feature, what the refusal names; None
# where the flag is accepted).
FLAGS = {
    'ar_steps': (['2'], None),
    'task': (['graphcast_37'], None),
    'remat_group': (['4'], None),
    'functional_step': ([], 'not ported: TPU-only'),
    'steps_per_call': (['4'], None),
    'pool_size': (['8'], None),
    'profile_dir': (['traces'], None),
    'prefetch': (['2'], None),
    'data_workers': (['2'], None),
    'dp': (['2'], None),
    'mp': (['2'], None),
    'multihost': ([], None),
    'coordinator': (['localhost:1234'], None),
    'process_id': (['0'], None),
    'num_processes': (['2'], None),
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
    assert (getattr(train.parse_args(argv), flag)
            == getattr(jax_train.parse_args(argv), flag))
    return
  with pytest.raises(SystemExit):
    train.parse_args(argv)
  err = capsys.readouterr().err
  assert 'unrecognized arguments' not in err
  assert f'--{flag}' in err and refusal in err


def test_port_parser_knows_every_reference_flag():
  """No flag of the reference's parser is unknown to the port's: all of
  them at their defaults parse."""
  reference = vars(jax_train.parse_args([]))
  port = vars(train.parse_args([]))
  assert set(reference) <= set(port), set(reference) - set(port)
