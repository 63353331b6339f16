"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it has its file under the harness."""

import json
import os
import re

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_contract():
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                             and not p.startswith("/") for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) == len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(configs)

    cells = [w["name"] for w in b["workloads"]]
    assert 1 <= len(cells) == len(set(cells)) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        traffic = harness.load_piece("traffic", w["traffic"])
        assert os.path.isfile(os.path.join(harness.PKG, "drivers", traffic["driver"] + ".py"))
    assert {w["config"] for w in b["workloads"]} == set(configs)

    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES and _line(m["layer"])
        assert os.path.isfile(os.path.join(harness.PKG, "metrics", m["name"] + ".py"))
        layers.add(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for c in cells:
        got = harness.cell_metrics(b, c)
        names = [m["name"] for m in got["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and got["per_layer"]
        for m in got["per_layer"]:
            assert m["moves"] in names
