"""``madsim_tpu_torch.scripts.replay_seed`` and ``sweep_million`` on the
CPU against the JAX package's ``scripts/replay_seed.py`` and
``scripts/sweep_million.py`` (``tests/_torch_scripts.py``): the raft
trace, fault plan and host-tier replay lines byte for byte, the etcd
history dump and verdict, and the sweep's JSON line across a ragged
final chunk (padded to the chunk and summarised through the
limit-masked reduction), 0 kernel builds or loads in its timed region."""

import pytest

import _torch_scripts as ts


@pytest.mark.parametrize("name", ["replay_volatile", "replay_etcd_history"])
def test_replay_seed_equals_the_reference(name, tmp_path, monkeypatch):
    ts.check_case(name, tmp_path, monkeypatch)


def test_sweep_million_ragged_tail_equals_the_reference(tmp_path, monkeypatch):
    import json

    port = ts.check_case("sweep_ragged", tmp_path, monkeypatch)
    line = json.loads(port["stdout"].splitlines()[-1])
    assert line["compiles_in_timed_region"] == 0
    assert (line["seeds"], line["chunk_size"], line["chunks_computed"]) == (24, 16, 2)
