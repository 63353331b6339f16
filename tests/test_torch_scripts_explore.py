"""``madsim_tpu_torch.scripts.explore_demo``, ``differential_demo``,
``steer_demo`` and ``fleet_smoke`` on the CPU against the JAX package's
scripts (``tests/_torch_scripts.py``): the campaign's JSONL report and
summary line (the gate's explore leg), the differential's report and
lines, a pinned bandit campaign's report and decision trace, and one
fleet worker's line over the plan's first unit. The Makefile's sizes
and the full drills are ``-m slow`` (``test_torch_scripts_golden.py``)."""

import pytest

import _torch_scripts as ts


@pytest.mark.parametrize(
    "name", ["explore_gate", "differential_gate", "steer_pinned", "fleet_one_unit"])
def test_driver_equals_the_reference(name, tmp_path, monkeypatch):
    ts.check_case(name, tmp_path, monkeypatch)
