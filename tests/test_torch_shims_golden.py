"""The golden file of ``chip_smoke.py`` phase 18 (c),
``madsim_tpu_torch/data/host_shims.json``: each shim program of
``_torch_shim_programs.SMOKE`` (the greeter's four call kinds,
kv_store's scenario, etcd, Kafka with a consumer group, S3 with a
multipart upload, the tokio runtime) over seeds ``0..n-1`` for each
``n`` of ``chip_smoke.SHIM_RUNS`` — the sha256 of the determinism logs
and of the outputs, and every seed's draw count and final virtual ns —
as the reference package computes them on its compiled core.

Written by the reference (``JAX_PLATFORMS=cpu python
tests/test_torch_shims_golden.py --write``); the test recomputes every
entry with both packages and holds each equal to the file.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import _torch_shim_programs as shims  # noqa: E402


def reference_golden() -> dict:
    import madsim_tpu as R

    return {f"seeds={n}": {name: shims.digest(R, program, n)
                           for name, program in sorted(shims.SMOKE.items())}
            for n in chip_smoke.SHIM_RUNS}


@pytest.mark.parametrize("seeds", chip_smoke.SHIM_RUNS)
@pytest.mark.parametrize("package", ["madsim_tpu", "madsim_tpu_torch"])
def test_shim_digests_equal_the_golden(package, seeds):
    import importlib

    ms = importlib.import_module(package)
    golden = chip_smoke.load_golden(chip_smoke.SHIMS_GOLDEN)[f"seeds={seeds}"]
    assert sorted(golden) == sorted(shims.SMOKE)
    for name, program in sorted(shims.SMOKE.items()):
        assert shims.digest(ms, program, seeds) == golden[name], name


def write() -> None:
    out = reference_golden()
    path = chip_smoke.data_path(chip_smoke.SHIMS_GOLDEN)
    with open(path, "w") as f:
        f.write(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {path}: {sorted(out)}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: JAX_PLATFORMS=cpu python tests/test_torch_shims_golden.py --write")
    write()
