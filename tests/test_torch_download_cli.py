"""The port's ERA5 download CLI (`gencast_tpu_torch.tools.download_era5`):
its `--dry_run` prints the root tool's CDS requests, line for line, for
GenCast and GraphCast tasks (the network path needs CDS credentials and
`cdsapi`, neither of which is here)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The cases of tests/test_download_cli.py.
CASES = {
    'gencast_full': ['--start', '2019-11', '--end', '2020-02',
                     '--resolution', '1.0', '--task', 'gencast_full'],
    'graphcast_13': ['--start', '2019-01', '--end', '2019-01',
                     '--resolution', '0.25', '--task', 'graphcast_13'],
}


def _requests(command, argv):
  r = subprocess.run(command + ['--out_dir', '/tmp/era5', '--dry_run']
                     + argv, capture_output=True, text=True, cwd=REPO,
                     timeout=120)
  assert r.returncode == 0, r.stderr
  return [json.loads(line) for line in r.stdout.splitlines()]


@pytest.mark.parametrize('task', sorted(CASES))
def test_dry_run_prints_the_root_tools_requests(task):
  got = _requests([sys.executable, '-m',
                   'gencast_tpu_torch.tools.download_era5'], CASES[task])
  want = _requests([sys.executable, os.path.join(REPO, 'tools',
                                                  'download_era5.py')],
                   CASES[task])
  assert got == want
  assert len(got) == (9 if task == 'gencast_full' else 3)
