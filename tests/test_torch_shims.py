"""Port parity: the simulation-mode ecosystem shims (``madsim_tpu_torch``'s
``grpc``, ``etcd``, ``kafka``, ``s3`` and ``tokio``) against the
reference's.

Every test of the reference's ``tests/test_grpc.py``, ``test_etcd.py``,
``test_kafka.py``, ``test_s3.py`` and the tokio tests of ``test_aux.py``
is a program of ``_torch_shim_programs.py``, written once over the
package module and keeping the reference test's assertions. Each runs
under ``madsim_tpu.Runtime(seed)`` and ``madsim_tpu_torch.Runtime(seed)``
(both on their compiled cores) at the reference test's seed, with equal
determinism logs, draw counts, final virtual ns and outputs; the
reference's ``check_determinism`` tests run under both packages' checker.
"""

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
import _torch_shim_programs as shims
from _torch_parity import assert_stdlib_restored, both, run, sub


@pytest.mark.parametrize("name", sorted(shims.PROGRAMS))
def test_shim_program_parity(name):
    program, seed = shims.PROGRAMS[name]
    ref = both(program, seed)
    assert ref["draws"] > 0 and ref["out"] is not None


@pytest.mark.parametrize("name", sorted(shims.DETERMINISM))
def test_check_determinism_passes_on_both(name):
    program, seed = shims.PROGRAMS[name][0], shims.DETERMINISM[name]
    outs = [ms.Runtime.check_determinism(seed, lambda ms=ms: program(ms)) for ms in (R, P)]
    assert_stdlib_restored()
    assert outs[0] == outs[1]


def test_group_interleaving_is_the_same_for_the_same_seed():
    """The reference's ``test_group_determinism``: a seed's group
    consumption interleaving repeats, in either package."""
    for ms in (R, P):
        a, b = (run(ms, shims.kafka_group_interleaving, 77) for _ in range(2))
        assert a == b and a["out"]


def test_tokio_reexports_surface():
    """The façade exposes the tokio module layout (lib.rs:38-50), name for
    name as the reference's does."""
    tokio = sub(P, "tokio")
    assert tokio.sync.channel and tokio.sync.oneshot and tokio.sync.Notify
    assert tokio.time.sleep and tokio.net.Endpoint and tokio.task.spawn
    ref = sub(R, "tokio")
    assert sorted(n for n in vars(tokio) if not n.startswith("_")) == sorted(
        n for n in vars(ref) if not n.startswith("_"))
    assert tokio.io.copy and tokio.process


def test_seeds_give_different_schedules():
    """The smoke programs of ``chip_smoke.py`` phase 18 (c) really depend
    on the seed (else their 64-seed digests would prove little)."""
    for program in (shims.kafka_smoke, shims.tokio_smoke):
        a, b = run(P, program, 1), run(P, program, 2)
        assert a["log"] != b["log"] and a["out"] != b["out"]
