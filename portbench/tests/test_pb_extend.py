"""A later change adds a configuration, a cell and a per-layer metric by
adding files: a copy of the harness gains one of each, and lists, loads
and runs them with no file of the copy edited but ``BENCHMARK.json``'s
entries. The result line has exactly the contract's keys."""

import hashlib
import json
import os
import shutil
import time

from portbench import harness, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_are_files(tmp_path):
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(pkg)

    cfg = json.loads((pkg / "configs" / "madraft-5n.json").read_text())
    cfg.update(name="madraft-3n", reduced=[])
    cfg["fields"]["num_nodes"] = 3
    cfg["engine"]["queue_capacity"] = 48
    (pkg / "configs" / "madraft-3n.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "sweep-tiny.json").write_text(json.dumps(
        {"driver": "chunked", "lanes": 8, "seed_stride": 2**32, "sample": 4}))
    (pkg / "metrics" / "events_per_step.raft3.py").write_text(
        "def read(records):\n"
        "    w = records.get('window') or {}\n"
        "    return w['events'] / w['steps'] if w.get('steps') else None\n")

    bench = harness.load_benchmark()
    bench["configs"].append({"name": "madraft-3n", "source": "https://github.com/madsim-rs/MadRaft",
                             "file": "portbench/configs/madraft-3n.json", "reduced": [],
                             "why": "a 3-node cluster"})
    bench["workloads"].append({"name": "raft3.tiny", "config": "madraft-3n",
                               "traffic": "sweep-tiny", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("raft3.tiny")
    bench["per_layer"].append({"name": "events_per_step.raft3", "unit": "events/step",
                               "better": "higher", "source": "program_counter",
                               "layer": "chunk driver", "moves": "events_per_s",
                               "workloads": ["raft3.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = harness.load_benchmark(str(tmp_path))

    wanted = harness.cell_metrics(bench, "raft3.tiny")
    assert [m["name"] for m in wanted["end_to_end"]] == ["events_per_s", "setup_s"]
    assert [m["name"] for m in wanted["per_layer"]] == ["events_per_step.raft3"]
    assert "raft3.tiny" not in [m["name"] for m in harness.cell_metrics(bench, "raft5.sweep")["per_layer"]]

    for trace in (False, True):
        line, _ = run.run_cell(bench, "raft3.tiny", 5, 1.0, trace, "cpu", pkg=str(pkg),
                               t_start=time.perf_counter())
        keys = KEYS + (["breakdown"] if trace else []) + ["compared"]
        assert list(line) == keys
        assert line["correct"], line["compared"]
        if trace:
            assert list(line["metrics"]) == ["events_per_step.raft3"]
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert {"busy_s", "window_s"} <= set(line["device"])
        else:
            assert list(line["metrics"]) == ["events_per_s", "setup_s"]
            assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
        json.dumps(line)
    after = _digests(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
