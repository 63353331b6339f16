"""Port parity: the host↔device differential
(``madsim_tpu_torch.explore.differential``) — the port's counterpart of
``tests/test_differential.py``.

The device half is the port's: ``device_outcomes_grid`` (one
spec-as-data sweep for the whole spec set) equals ``device_outcomes``
per spec and the reference's grid, every ``TierOutcome`` field a plain
``int``; ``run_differential``'s report bytes equal the reference's when
the host tier's outcomes come from the reference's own
``host_outcomes``; both of the reference's results equal ``chip_smoke.py``
phase 16 (c)'s rehearsal golden. The port's host half runs live on the
port's own host runtime and equals the reference's on a grid that
``data/differential_host.json`` (a golden only) does not hold."""

import json

import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu.explore import differential as rdiff
from madsim_tpu_torch.explore import differential as pdiff

import chip_smoke
from _torch_parity import port_ecfg

# the reference test's small grid, 16 seeds at a 1 s horizon, over all
# four gate specs: chip_smoke.py phase 16 (c)'s rehearsal config, so the
# reference's results are also held to its golden here
GRID = dict(seeds=16, sim_seconds=1.0)
SPECS = 4


@pytest.fixture(scope="module")
def ref_grid():
    return rdiff.device_outcomes_grid(rdiff.gate_specs()[:SPECS], rdiff.DifferentialConfig(**GRID))


@pytest.fixture(scope="module")
def port_grid():
    return pdiff.device_outcomes_grid(pdiff.gate_specs()[:SPECS],
                                      pdiff.DifferentialConfig(**GRID), device="cpu")


def _golden(what: str, run):
    assert run == (GRID["seeds"], GRID["sim_seconds"])
    return chip_smoke.load_golden(chip_smoke.DIFF_GOLDEN)[what][chip_smoke.diff_key(run)]


def test_configs_and_specs_equal_reference():
    assert pdiff.DifferentialConfig()._asdict() == rdiff.DifferentialConfig()._asdict()
    assert pdiff.TierOutcome._fields == rdiff.TierOutcome._fields
    assert pdiff.TierOutcome._field_defaults == rdiff.TierOutcome._field_defaults
    assert [s._asdict() for s in pdiff.gate_specs()] == [s._asdict() for s in rdiff.gate_specs()]
    for count, total in ((0, 200), (1, 3), (199, 200), (7, 16)):
        assert pdiff._pm(count, total) == rdiff._pm(count, total)
    dcfg = dict(GRID, num_nodes=5, history_ring=32)
    for spec in rdiff.gate_specs()[:1]:
        (_, recfg), (_, pecfg) = (rdiff._device_raft_cfg(spec, rdiff.DifferentialConfig(**dcfg)),
                                  pdiff._device_raft_cfg(spec, pdiff.DifferentialConfig(**dcfg)))
        assert port_ecfg(recfg) == pecfg


def test_device_grid_equals_reference(ref_grid, port_grid):
    assert [o._asdict() for o in port_grid] == [o._asdict() for o in ref_grid]
    assert [o._asdict() for o in ref_grid] == _golden("grids", chip_smoke.DIFF_GRID_RUNS[1])
    for o in port_grid:
        assert all(type(v) is int for v in o), o
        assert o.elected_seeds + o.no_leader_seeds == GRID["seeds"]
        assert o.hist_mismatch_seeds == 0 and o.hist_overflow_seeds == 0


def test_device_grid_equals_device_outcomes_per_spec(port_grid):
    """The first two specs (a crash storm, asymmetric partitions) swept
    one at a time equal their lanes of the grid."""
    dcfg = pdiff.DifferentialConfig(**GRID)
    for spec, grid_out in zip(pdiff.gate_specs()[:2], port_grid):
        assert pdiff.device_outcomes(spec, dcfg, device="cpu") == grid_out


def test_compare_equals_reference(ref_grid):
    dcfg = dict(GRID, tol_violation_pm=50)
    for dev in ref_grid:
        for host in (dev, dev._replace(elected_seeds=0, no_leader_seeds=16),
                     dev._replace(violation_seeds=dev.violation_seeds + 3, hist_mismatch_seeds=1)):
            want = rdiff.compare(dev, host, rdiff.DifferentialConfig(**dcfg))
            got = pdiff.compare(pdiff.TierOutcome(*dev), pdiff.TierOutcome(*host),
                                pdiff.DifferentialConfig(**dcfg))
            assert got == want


def test_run_differential_report_bytes_equal_reference(tmp_path):
    """The port's report, its host half the reference's ``host_outcomes``
    (as the reference's own report carries them), is the reference's
    report byte for byte."""
    specs = rdiff.gate_specs()[:SPECS]
    rcfg = rdiff.DifferentialConfig(**GRID)
    want = rdiff.run_differential(specs, rcfg, report_path=str(tmp_path / "ref.json"))
    host = [pdiff.TierOutcome(**rec["host"]) for rec in want["specs"]]
    got = pdiff.run_differential(pdiff.gate_specs()[:SPECS], pdiff.DifferentialConfig(**GRID),
                                 report_path=str(tmp_path / "port.json"), host=host,
                                 device="cpu")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert got == want == json.loads((tmp_path / "port.json").read_text())
    assert (tmp_path / "ref.json").read_text() == _golden("reports", chip_smoke.DIFF_RUNS[1])


def test_host_outcomes_come_from_data_and_refuse_a_missing_grid():
    """The host half runs live on the port's host runtime: a grid that
    ``differential_host.json`` does not hold (17 seeds) gives the
    reference's outcomes, and so does ``run_differential`` without
    ``host=`` on another such grid. ``host=`` must still carry one
    outcome per spec."""
    dcfg = pdiff.DifferentialConfig(seeds=17)
    table = chip_smoke.load_golden(chip_smoke.DIFF_HOST_GOLDEN)["host"]
    assert pdiff.host_key(pdiff.gate_specs()[0], dcfg) not in table
    got = pdiff.host_outcomes(pdiff.gate_specs()[0], dcfg)
    want = rdiff.host_outcomes(rdiff.gate_specs()[0], rdiff.DifferentialConfig(seeds=17))
    assert got._asdict() == want._asdict()
    assert got.elected_seeds + got.no_leader_seeds == dcfg.seeds
    small = dict(seeds=3, sim_seconds=0.5)
    got = pdiff.run_differential(pdiff.gate_specs()[:1], pdiff.DifferentialConfig(**small),
                                 device="cpu")
    want = rdiff.host_outcomes(rdiff.gate_specs()[0], rdiff.DifferentialConfig(**small))
    assert got["specs"][0]["host"] == want._asdict()
    with pytest.raises(ValueError, match="host outcomes"):
        pdiff.run_differential(pdiff.gate_specs()[:2], pdiff.DifferentialConfig(**small),
                               host=[got["specs"][0]["host"]], device="cpu")
