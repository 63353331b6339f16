"""``madsim_tpu_torch.scripts.multichip_campaign --smoke`` (a world of 2
CPU ranks: the checked-sweep curve over 1 and 2 ranks and the campaign's
report sha256 at both) and ``obs_smoke`` (telemetry out of band on both
drivers, the event-mix plane) on the CPU against the JAX package's
scripts (``tests/_torch_scripts.py``)."""

import pytest

import _torch_scripts as ts


@pytest.mark.parametrize("name", ["multichip_smoke", "obs_smoke"])
def test_driver_equals_the_reference(name, tmp_path, monkeypatch):
    ts.check_case(name, tmp_path, monkeypatch)
