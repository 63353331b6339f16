"""Port parity: the real-mode twin (``from madsim_tpu_torch import real``)
against the reference's ``madsim_tpu.real``.

Every test of the reference's ``tests/test_real.py``,
``test_real_etcd.py``, ``test_real_fs_signal.py``, ``test_real_grpc.py``
and ``test_real_kafka_s3.py`` runs as a case through both packages
(``_torch_ref_tests``), one after the other, each server on its own
ephemeral localhost port, with SIGINT's handler checked back to the
original after every run. The programs of ``_torch_real_programs.py``
(the greeter example, one etcd, Kafka and S3 round trip each) return
their values, error codes, status code names and exception type names,
which must be equal across the packages; their digests, as the
reference gives them, are ``madsim_tpu_torch/data/real_outcomes.json``
(``python tests/test_torch_real.py --write``), which ``chip_smoke.py``
phase 19 (d) holds the port to. The restricted codec gives the
reference's bytes for plain values, and for registered and ``Request``
types once the module prefix is mapped; the port refuses to decode a
``madsim_tpu.`` type name.
"""

import json
import os
import signal
import struct
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import madsim_tpu as R  # noqa: E402
import madsim_tpu_torch as P  # noqa: E402
from madsim_tpu.net.rpc import Request as RRequest  # noqa: E402
from madsim_tpu.real import codec as rcodec  # noqa: E402
from madsim_tpu_torch.net.rpc import Request as PRequest  # noqa: E402
from madsim_tpu_torch.real import codec as pcodec  # noqa: E402

import _torch_real_programs as programs  # noqa: E402
import _torch_ref_tests as ref_tests  # noqa: E402

GOLDEN = os.path.join(REPO, "madsim_tpu_torch", "data", "real_outcomes.json")
FILES = ["test_real", "test_real_etcd", "test_real_fs_signal", "test_real_grpc",
         "test_real_kafka_s3"]
CASES = [(f, c) for f in FILES for c in ref_tests.cases(f)]


@pytest.mark.parametrize("name,case", CASES, ids=[f"{f}::{c}" for f, c in CASES])
def test_reference_real_case(name, case, tmp_path):
    ref_tests.run_case(name, case, tmp_path)


@pytest.mark.parametrize("name", ["greeter_real", "etcd_roundtrip", "kafka_roundtrip",
                                  "s3_roundtrip"])
def test_real_program_outcomes_equal(name):
    before = signal.getsignal(signal.SIGINT)
    ref = programs.SMOKE[name](R)
    port = programs.SMOKE[name](P)
    assert signal.getsignal(signal.SIGINT) is before
    assert port == ref
    assert port


def test_golden_holds_the_reference_outcomes():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden == {name: programs.digest(program(R))
                      for name, program in programs.SMOKE.items()}


def test_greeter_real_prints_the_reference_lines():
    assert programs.greeter_real(P) == [
        "unary: Hello world!",
        "server-stream: 0: Hello stream!",
        "server-stream: 1: Hello stream!",
        "server-stream: 2: Hello stream!",
        "client-stream: Hello a, b, c!",
        "bidi: Hello x!",
        "bidi: Hello y!",
        "error path: INVALID_ARGUMENT - invalid name: error",
    ]


# -- the restricted codec ----------------------------------------------------

plain = st.recursive(
    st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False) | st.text()
    | st.binary(),
    lambda children: st.lists(children, max_size=4) | st.tuples(children, children)
    | st.dictionaries(st.integers() | st.text(max_size=4), children, max_size=4),
    max_leaves=12,
)


@settings(max_examples=150, deadline=None)
@given(plain)
def test_codec_plain_values_give_equal_bytes(obj):
    raw = pcodec.dumps(obj)
    assert raw == rcodec.dumps(obj)
    assert rcodec.loads(raw) == pcodec.loads(raw) == obj


class RPing(RRequest):
    def __init__(self, value):
        self.value = value


class PPing(PRequest):
    def __init__(self, value):
        self.value = value


def test_codec_request_and_registered_types_map_by_module_prefix():
    """``codec.py`` keys a type ``module::qualname``: the two packages'
    bytes for a ``Request`` and for a registered class and enum differ
    only by that name."""
    import enum

    def mapped(raw: bytes, a: str, b: str) -> bytes:
        """``raw`` with the length-prefixed type name ``a`` as ``b``."""
        a, b = a.encode(), b.encode()
        return raw.replace(struct.pack(">I", len(a)) + a, struct.pack(">I", len(b)) + b)

    obj_r, obj_p = (7, RPing([1, b"x"]), "s"), (7, PPing([1, b"x"]), "s")
    raw_r, raw_p = rcodec.dumps(obj_r), pcodec.dumps(obj_p)
    assert raw_p == mapped(raw_r, f"{__name__}::RPing", f"{__name__}::PPing")
    back = pcodec.loads(raw_p)
    assert type(back[1]) is PPing and back[1].value == [1, b"x"]

    class Color(enum.Enum):
        RED = 1

    status_r = R.grpc.Status.not_found("gone")
    status_p = P.grpc.Status.not_found("gone")
    raw_r, raw_p = rcodec.dumps(status_r), pcodec.dumps(status_p)
    for name in ("Status", "Code"):
        raw_r = mapped(raw_r, f"madsim_tpu.grpc.status::{name}",
                       f"madsim_tpu_torch.grpc.status::{name}")
    assert raw_p == raw_r
    assert pcodec.dumps(P.grpc.Code.NOT_FOUND) == mapped(
        rcodec.dumps(R.grpc.Code.NOT_FOUND), "madsim_tpu.grpc.status::Code",
        "madsim_tpu_torch.grpc.status::Code")
    got = pcodec.loads(raw_p)
    assert (type(got).__name__, got.code, got.message) == ("Status", P.grpc.Code.NOT_FOUND, "gone")
    for codec in (rcodec, pcodec):
        codec.register(Color)
    try:
        assert pcodec.dumps(Color.RED) == rcodec.dumps(Color.RED)
    finally:
        for codec in (rcodec, pcodec):
            del codec._EXTRA_TYPES[f"{Color.__module__}::{Color.__qualname__}"]


def test_port_refuses_to_decode_a_reference_type_name():
    """A frame the reference encodes names its types
    ``madsim_tpu.<module>::<qualname>``; no such type is registered in the
    port, which refuses the frame."""
    for obj in (R.grpc.Status.not_found("gone"), R.grpc.Code.NOT_FOUND):
        raw = rcodec.dumps(obj)
        assert b"madsim_tpu.grpc.status::" in raw
        with pytest.raises(pcodec.CodecError,
                           match="unregistered type 'madsim_tpu.grpc.status::"):
            pcodec.loads(raw)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_real.py --write")
    with open(GOLDEN, "w") as f:
        json.dump({name: programs.digest(program(R)) for name, program in programs.SMOKE.items()},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
