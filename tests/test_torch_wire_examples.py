"""Port parity: the port's wire examples
(``madsim_tpu_torch/examples/greeter_wire.py`` and ``wire_servers.py``)
against the repository's ``examples/greeter_wire.py`` and
``examples/wire_servers.py``: each example's ``main()`` runs in both
packages, one after the other, and prints the same lines once the
ephemeral ports are masked. Both examples need grpcio (the stock client
side) and skip without it; ``wire_servers``'s S3 half uses aiohttp.
"""

import contextlib
import io
import re

import pytest

pytest.importorskip("grpc")

import madsim_tpu as R  # noqa: E402
import madsim_tpu_torch as P  # noqa: E402

import _torch_real_programs as programs  # noqa: E402

PORT = re.compile(r"127\.0\.0\.1:\d+")


def _printed(ms, name: str) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        programs.sub(ms, "real").Runtime().block_on(programs.example(ms, name).main())
    return PORT.sub("127.0.0.1:<port>", out.getvalue()).splitlines()


@pytest.mark.parametrize("name,lines", [("greeter_wire", 6), ("wire_servers", 8)])
def test_example_prints_the_reference_lines(name, lines):
    ref = _printed(R, name)
    assert len(ref) >= lines, ref
    assert _printed(P, name) == ref
