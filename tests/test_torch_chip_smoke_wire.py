"""``chip_smoke.py`` phase 20 rehearsed on the CPU: the wire rig's
determinism reports for seeds 0-1 (both server kinds, telemetry on and
off) against ``wire_load_determinism.json``, and the Kafka fuzz digests on
loopback and over localhost TCP against ``kafka_fuzz.json``. Leg (c), the
smoke rig as a fresh ``python -m madsim_tpu_torch.wire_load --smoke``
subprocess with its gate and parity held, runs only under ``-m slow``.
No kernel launches."""

import pytest
import torch

import chip_smoke


def test_wire_phase_on_the_plain_path():
    out = chip_smoke.phase_wire(torch.device("cpu"), smoke=False)
    assert out["launches"] == 0
    assert out["a"] == {"reports": 8}
    assert out["b"] == {"loopback": 50, "tcp": 5}
    assert "c" not in out and set(out["seconds"]) == {"a", "b"}


@pytest.mark.slow
def test_wire_phase_with_the_smoke_rig():
    out = chip_smoke.phase_wire(torch.device("cpu"))
    assert out["launches"] == 0 and set(out["seconds"]) == {"a", "b", "c"}
    load = out["c"]["load"]
    assert out["c"]["parity"] and load["gate_failures"] == []
    assert load["clients"] == 64 and load["total_ops"] > 0 and load["peak_open_conns"] > 0
