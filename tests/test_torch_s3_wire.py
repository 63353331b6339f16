"""Port parity: the S3 REST wire (``madsim_tpu_torch.s3.wire``: the
path-style REST meaning ``S3Rest`` over ``S3Service``, the ``WireServer``
on the shared serving core and the ``LegacyWireServer``) against the
reference's ``madsim_tpu.s3.wire``.

Every test of the reference's ``tests/test_s3_wire.py`` runs as a case
through both packages (``_torch_ref_tests``); it needs aiohttp and skips
without it, as the reference's does. Beside them: the determinism mode's
S3 session (``_torch_wire.s3_transcript``: buckets, puts, gets, deletes
and multipart uploads over keep-alive HTTP on a counter clock) records
the same transcript in both packages, and a transcript either package's
``S3Rest`` recorded replays through the other's fresh ``S3Rest`` on the
recorded clock feed (as ``Cluster.replay_s3`` replays it) to the same
``(status, body, headers)``, byte for byte.
"""

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P

import _torch_ref_tests as ref_tests
import _torch_wire as wires

S3_WIRE = "test_s3_wire"


@pytest.mark.parametrize("case", ref_tests.cases(S3_WIRE))
def test_reference_s3_wire_case(case, tmp_path):
    ref_tests.run_case(S3_WIRE, case, tmp_path)


def _plain(transcript):
    """A transcript as plain data, without the ``Host`` header (it names
    the server's ephemeral port)."""
    return [((r.method, r.path, sorted(r.query.items()),
              sorted((k, v) for k, v in r.headers.items() if k != "host"), r.body),
             clock, rsp) for r, clock, rsp in transcript]


@pytest.mark.parametrize("seed", [0, 1])
def test_s3_sessions_record_the_same_transcript(seed):
    ref = wires.s3_transcript(R, seed)
    assert len(ref) > 20
    assert _plain(wires.s3_transcript(P, seed)) == _plain(ref)


@pytest.mark.parametrize("recorder,replayer", [(R, P), (P, R)],
                         ids=["reference-recorded", "port-recorded"])
def test_s3_transcript_replays_across_packages(recorder, replayer):
    transcript = wires.s3_transcript(recorder, 0)
    assert any("uploadId" in req.query for req, _clk, _rsp in transcript)
    feed = [clock for _req, clock, _rsp in transcript]
    rest = wires.sub(replayer, "s3.wire").S3Rest(clock_ms=lambda: feed.pop(0))
    for req, _clock, (status, body, headers) in transcript:
        assert rest.handle(req) == (status, body, headers)
    assert not feed
