"""The reader of ``graph_share.etcd`` on synthetic records: 100 when
every step of the window's chunks was replayed, the fraction when some
ran eagerly, None when the program observed no graph steps."""

import pytest

from portbench import harness


def _read(records):
    return harness.load_module("metrics", "graph_share.etcd").read(records)


def test_every_step_replayed_reads_100():
    tel = {"sweep_chunk_steps": [192, 256, 192], "sweep_chunk_graph_steps": [192, 256, 192]}
    assert _read({"telemetry": tel}) == pytest.approx(100.0)


def test_some_steps_eager_read_the_fraction():
    tel = {"sweep_chunk_steps": [100, 256], "sweep_chunk_graph_steps": [96, 0]}
    assert _read({"telemetry": tel}) == pytest.approx(100.0 * 96 / 356)


def test_absent_observation_reads_none():
    assert _read({}) is None
    assert _read({"telemetry": None}) is None
    # the parent's driver observes the steps but no graph steps
    assert _read({"telemetry": {"sweep_chunk_steps": [192, 256]}}) is None
    assert _read({"telemetry": {"sweep_chunk_steps": [0],
                                "sweep_chunk_graph_steps": [0]}}) is None
