"""Port parity: ``madsim_tpu_torch.real.grpc``'s grpcio bridge against the
reference's, where grpcio is installed (the reference's own test of it,
``tests/test_real_grpcio.py``, skips the same way).

Every test of ``tests/test_real_grpcio.py`` runs as a case through both
packages, one after the other (``_torch_ref_tests``). One process's
protobuf descriptor pool holds a ``.proto`` file once, so the port's
copy of the test compiles its schema under the package name
``interopwire_port``; the wire paths, messages and status codes it
checks are otherwise the reference test's.
"""

import pytest

pytest.importorskip("grpc")

import _torch_ref_tests as ref_tests  # noqa: E402

GRPCIO = "test_real_grpcio"
RENAMES = (("interopwire", "interopwire_port"),)


@pytest.mark.parametrize("case", ref_tests.cases(GRPCIO))
def test_reference_grpcio_case(case, tmp_path):
    ref_tests.run_case(GRPCIO, case, tmp_path, renames=RENAMES)
