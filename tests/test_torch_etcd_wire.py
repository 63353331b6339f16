"""Port parity: the etcd v3 gRPC wire (``madsim_tpu_torch.etcd.wire``:
KV, Lease, Watch, Maintenance, Election and Lock over ``EtcdService``,
``acquire_candidacy`` and the grpcio ``WireServer``) against the
reference's ``madsim_tpu.etcd.wire``.

Every test of the reference's ``tests/test_etcd_wire.py`` runs as a case
through both packages (``_torch_ref_tests``), with its stock gRPC client
dialing ``/etcdserverpb.KV/Range`` and the rest. The schema
(``ETCD_PROTO``, ``ELECTION_PROTO``, ``LOCK_PROTO`` and their file names)
is the reference's byte for byte, since the package name is on the wire:
where both packages compile it in one process, the second compile reuses
the generated modules once their descriptors match. Without grpcio the
module skips, as the reference's test does, and the protoc-dependent
cases keep their ``needs_protoc`` guard.
"""

import pytest

pytest.importorskip("grpc")

import madsim_tpu.etcd.wire as rwire  # noqa: E402
import madsim_tpu_torch.etcd.wire as pwire  # noqa: E402

import _torch_ref_tests as ref_tests  # noqa: E402

ETCD_WIRE = "test_etcd_wire"


@pytest.mark.parametrize("case", ref_tests.cases(ETCD_WIRE))
def test_reference_etcd_wire_case(case, tmp_path):
    ref_tests.run_case(ETCD_WIRE, case, tmp_path)


def test_the_schema_is_the_reference_schema():
    assert (pwire.ETCD_PROTO, pwire.ELECTION_PROTO, pwire.LOCK_PROTO) == (
        rwire.ETCD_PROTO, rwire.ELECTION_PROTO, rwire.LOCK_PROTO)
    ref = sorted(rwire.wire_pkg().services)  # the reference compiles first, as in every case
    assert sorted(pwire.wire_pkg().services) == ref
