"""Port parity: the genuine Kafka wire (``madsim_tpu_torch.kafka.wire``) and
its probe client (``kafka.probe``) against the reference's.

Every test of the reference's ``tests/test_kafka_wire.py`` runs as a case
through both packages (``_torch_ref_tests``). Beside them: crc32c,
varints and record batches give the same bytes; the probe session through
``LoopbackTransport`` on a fixed clock gives the same transcript bytes in
all four pairings of client and wire; a transcript one package recorded
replays byte for byte through the other's fresh ``KafkaWire``; and over
localhost TCP the port's ``ProbeClient`` against the reference's
``WireServer`` and the reference's against the port's give the outcomes
of either package alone (the frames are Kafka's binary protocol, with no
Python type name in them).
"""

import random

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
from madsim_tpu.kafka import wire as rwire
from madsim_tpu_torch.kafka import wire as pwire

import _torch_real_programs as programs
import _torch_ref_tests as ref_tests

WIRE = "test_kafka_wire"


@pytest.mark.parametrize("case", ref_tests.cases(WIRE))
def test_reference_kafka_wire_case(case, tmp_path):
    ref_tests.run_case(WIRE, case, tmp_path)


def test_codec_units_give_equal_bytes():
    rng = random.Random(5)
    for n in (0, 1, 7, 64, 1000):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert pwire.crc32c(data) == rwire.crc32c(data)
        assert pwire.crc32c(data, 0x1234) == rwire.crc32c(data, 0x1234)
    values = [0, 1, -1, 63, -64, 64, 300, -301, 2**31 - 1, -(2**31), 2**62, -(2**62)]
    values += [rng.randrange(-(2**63), 2**63) for _ in range(200)]
    for v in values:
        raw = pwire.Writer().varint(v).done()
        assert raw == rwire.Writer().varint(v).done()
        assert rwire.Reader(raw).varint() == pwire.Reader(raw).varint() == v
        if v >= 0:
            assert pwire.Writer().uvarint(v).done() == rwire.Writer().uvarint(v).done()
    for base in (0, 37, 2**40):
        records = [(1_000 + 7 * i, None if i % 3 == 1 else f"k{i}".encode(),
                    None if i % 4 == 2 else bytes(rng.randrange(256) for _ in range(i)))
                   for i in range(9)]
        blob = pwire.encode_record_batch(base, records)
        assert blob == rwire.encode_record_batch(base, records)
        assert pwire.decode_record_batches(blob) == rwire.decode_record_batches(blob)
    assert pwire.frame(b"abc") == rwire.frame(b"abc")
    assert pwire.SUPPORTED_APIS == rwire.SUPPORTED_APIS


def test_loopback_transcripts_equal_in_every_pairing():
    runs = {(c.__name__, w.__name__): programs.loopback_transcript(c, w)
            for c in (R, P) for w in (R, P)}
    want = runs[("madsim_tpu", "madsim_tpu")]
    assert len(want[1]) > 30
    for key, got in runs.items():
        assert got == want, key


@pytest.mark.parametrize("recorder,replayer", [(R, P), (P, R)],
                         ids=["reference-recorded", "port-recorded"])
def test_transcript_replays_across_packages(recorder, replayer):
    _out, transcript = programs.loopback_transcript(recorder)
    clock = [now for _req, now, _rsp in transcript]
    wire = programs.sub(replayer, "kafka.wire").KafkaWire(clock_ms=lambda: clock.pop(0))
    for req, _now, rsp in transcript:
        assert wire.handle_frame(req) == rsp


def test_probe_clients_and_wire_servers_interoperate_both_ways():
    same = programs.probe_session(R)
    assert programs.probe_session(P) == same
    assert programs.probe_session(P, R) == same  # the port's client, the reference's server
    assert programs.probe_session(R, P) == same  # the reference's client, the port's server
    assert same["heartbeats"] == [0, rwire.ERR_REBALANCE_IN_PROGRESS, 0,
                                  rwire.ERR_REBALANCE_IN_PROGRESS]
