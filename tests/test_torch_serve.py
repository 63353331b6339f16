"""Port parity: the shared async wire-serving core
(``madsim_tpu_torch.serve``: ``framing``, ``core``, ``adapters``) against
the reference's ``madsim_tpu.serve``.

Every test of the reference's ``tests/test_serve.py`` runs as a case
through both packages (``_torch_ref_tests``), bar
``test_wire_load_smoke_end_to_end``, which drives the multi-process load
rig (``serve/loadgen.py``), not ported yet.
"""

import pytest

import _torch_ref_tests as ref_tests

SERVE = "test_serve"


@pytest.mark.parametrize(
    "case", ref_tests.cases(SERVE, exclude=("test_wire_load_smoke_end_to_end",)))
def test_reference_serve_case(case, tmp_path):
    ref_tests.run_case(SERVE, case, tmp_path)


def test_serve_exports_the_reference_names_without_loadgen():
    import sys

    import madsim_tpu.serve as R
    import madsim_tpu_torch.serve as P

    assert P.__all__ == R.__all__
    assert "madsim_tpu_torch.serve.loadgen" not in sys.modules
