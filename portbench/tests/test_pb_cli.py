"""The command as the benchmark runs it: without a CUDA card it prints no
result and exits with another code than 0; on the card (``gpu``) each
cell's short run prints the contract's result line, correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness


def _run(cell, seconds, trace=0):
    env = dict(os.environ, BENCH_RUN="x")
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run("raft5.sweep", 1)
    assert out.returncode != 0 and out.stdout == "", (out.returncode, out.stdout)
    assert "CUDA" in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["raft5.sweep", "etcd.checked-clean"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(cell, 3)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {m["name"] for m in
                                    harness.cell_metrics(harness.load_benchmark(), cell)["end_to_end"]}
