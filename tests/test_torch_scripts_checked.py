"""``madsim_tpu_torch.scripts.checked_sweep_demo``, ``oracle_demo`` and
``stream_smoke`` on the CPU against the JAX package's scripts
(``tests/_torch_scripts.py``): the checked sweep's report bytes, the
oracle pipeline's steps (seeds, fingerprints, shrink sizes and history
bytes; its elapsed times aside) and the stream smoke's five contracts
with the reference's counts and occupancies."""

import pytest

import _torch_scripts as ts


@pytest.mark.parametrize("name", ["checked_small", "oracle_demo", "stream_smoke"])
def test_driver_equals_the_reference(name, tmp_path, monkeypatch):
    ts.check_case(name, tmp_path, monkeypatch)
