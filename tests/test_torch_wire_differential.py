"""Port parity: the Kafka wire-vs-broker differential
(``madsim_tpu_torch.kafka.fuzz``) and the wire differentials of the
reference's ``tests/test_wire_differential.py``.

Its four legs (etcd over gRPC, which needs grpcio; S3 over HTTP, which
needs aiohttp; Kafka on loopback and over localhost TCP) run as cases
through both packages (``_torch_ref_tests``), each guarded as in the
reference. Beside them: ``fuzz_seed``'s digest, a pure function of the
seed, is the reference's for seeds 0-49 on loopback, and in the mixed
pairings (the port's fuzz and ``ProbeClient`` into the reference's
``KafkaWire``, and the reverse) for seeds 0-9: the frames are Kafka's
binary protocol, so nothing package-specific crosses. The reference's
digests are ``madsim_tpu_torch/data/kafka_fuzz.json`` (seeds 0-49 at 40
ops on loopback, seeds 1-5 at 30 ops over TCP), which ``chip_smoke.py``
phase 20 (b) holds the port to; ``python tests/test_torch_wire_differential.py
--write`` makes it from the JAX package.
"""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import madsim_tpu as R  # noqa: E402
import madsim_tpu_torch as P  # noqa: E402

import _torch_ref_tests as ref_tests  # noqa: E402
import _torch_wire as wires  # noqa: E402

DIFF = "test_wire_differential"
GOLDEN = os.path.join(REPO, "madsim_tpu_torch", "data", "kafka_fuzz.json")
LOOPBACK_SEEDS, LOOPBACK_OPS = range(50), 40
TCP_SEEDS, TCP_OPS = (1, 2, 3, 4, 5), 30
MIXED_SEEDS = range(10)


@pytest.mark.parametrize("case", ref_tests.cases(DIFF))
def test_reference_wire_differential_case(case, tmp_path):
    ref_tests.run_case(DIFF, case, tmp_path)


def _golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_loopback_fuzz_digests_equal_the_reference():
    golden = _golden()["loopback"]
    assert (golden["seeds"], golden["ops"]) == (list(LOOPBACK_SEEDS), LOOPBACK_OPS)
    ref = wires.fuzz_digests(R, LOOPBACK_SEEDS, LOOPBACK_OPS)
    assert ref == golden["digests"]
    assert wires.fuzz_digests(P, LOOPBACK_SEEDS, LOOPBACK_OPS) == ref
    assert len(set(ref)) == len(ref)


@pytest.mark.parametrize("fuzz_ms,wire_ms", [(P, R), (R, P)],
                         ids=["port-client-reference-wire", "reference-client-port-wire"])
def test_mixed_pairings_give_the_reference_digests(fuzz_ms, wire_ms):
    want = _golden()["loopback"]["digests"][:len(MIXED_SEEDS)]
    assert wires.fuzz_digests(fuzz_ms, MIXED_SEEDS, LOOPBACK_OPS, wire_ms=wire_ms) == want


def test_tcp_golden_is_the_reference_transport_free_digest():
    """The TCP digests of the golden are the reference's, which its own
    test holds equal to the loopback digest at the same ops; the port's
    TCP run is ``chip_smoke.py``'s and the reference test's (cases
    above)."""
    golden = _golden()["tcp"]
    assert (golden["seeds"], golden["ops"]) == (list(TCP_SEEDS), TCP_OPS)
    assert golden["digests"] == wires.fuzz_digests(R, TCP_SEEDS, TCP_OPS)
    assert wires.fuzz_digests(P, TCP_SEEDS, TCP_OPS) == golden["digests"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_wire_differential.py --write")
    golden = {
        "loopback": {"seeds": list(LOOPBACK_SEEDS), "ops": LOOPBACK_OPS,
                     "digests": wires.fuzz_digests(R, LOOPBACK_SEEDS, LOOPBACK_OPS)},
        "tcp": {"seeds": list(TCP_SEEDS), "ops": TCP_OPS,
                "digests": wires.fuzz_tcp_digests(R, TCP_SEEDS, TCP_OPS)},
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
