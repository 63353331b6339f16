"""Building the port's hand-written CUDA kernels at first use.

``build(name, symbol, argtypes)`` compiles ``csrc/<name>.cu`` with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
under the git-ignored ``madsim_tpu_torch/_build/``, loads it with
``ctypes`` and binds the entry point ``symbol``. The library's file name
carries a hash of the source, of every ``csrc`` header and of the flags,
so an edited kernel is rebuilt and an unchanged one is loaded as it is.
A compiler error raises; nothing falls back to torch ops. ``LOGS[name]``
keeps the compiler's output (the ``-Xptxas -v`` register and spill
report) of a build made in this process.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _tag(src_path: str) -> str:
    h = hashlib.sha256()
    for path in [src_path] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, symbol: str, argtypes: Sequence) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (unless an identical build exists), load
    it and bind ``symbol`` (returning a C ``int``) once per process."""
    if name in _LIBS:
        return _LIBS[name]
    src = source(name)
    so = os.path.join(BUILD_DIR, f"lib{name}_{_tag(src)}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True, timeout=600,
            )
            LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{LOGS[name]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
