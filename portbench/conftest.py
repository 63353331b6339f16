"""pytest settings of the benchmark's own tests (``portbench/tests``):
the repository root on the path, and the ``gpu`` marker for tests that
need a CUDA card (each decides inside the test, never at import)."""

import os
import sys

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _repo not in sys.path:
    sys.path.insert(0, _repo)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where none is present")
