"""Port parity: the shared async wire-serving core
(``madsim_tpu_torch.serve``: ``framing``, ``core``, ``adapters``) against
the reference's ``madsim_tpu.serve``.

Every test of the reference's ``tests/test_serve.py`` runs as a case
through both packages (``_torch_ref_tests``); its ``slow`` load-rig smoke
has its port counterpart in ``test_torch_wire_load.py``.
"""

import os
import subprocess
import sys

import pytest

import _torch_ref_tests as ref_tests

SERVE = "test_serve"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", ref_tests.cases(SERVE))
def test_reference_serve_case(case, tmp_path):
    ref_tests.run_case(SERVE, case, tmp_path)


def test_serve_exports_the_reference_names_without_loadgen():
    """Both packages' ``serve`` export the same names, and importing the
    port's (in a fresh interpreter) loads no ``serve.loadgen``."""
    import madsim_tpu.serve as R
    import madsim_tpu_torch.serve as P

    assert P.__all__ == R.__all__
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    code = ("import sys\nimport madsim_tpu_torch.serve\n"
            "assert 'madsim_tpu_torch.serve.loadgen' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
