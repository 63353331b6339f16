"""The reference's own tests of a host-tier module, run as parity cases.

``pair(name)`` gives the reference's ``tests/<name>.py`` module and the
same source with every ``madsim_tpu`` import turned into
``madsim_tpu_torch`` (and ``examples.<x>`` into the port's
``madsim_tpu_torch.examples.<x>``), loaded as the module
``_port_<name>``. ``run_case`` runs one test function of each, the
reference's first and then the port's (never nested: real mode owns the
process's event loop and SIGINT), each with fixtures of its own, and
checks after each run that SIGINT's handler is back to the one it found.

The reference's assertions stay exactly as written: every value, error
code, gRPC status code and exception type a test pins must come out of
both packages alike.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
import re
import signal
import sys
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))


def port_source(src: str, renames=()) -> str:
    src = re.sub(r"\bmadsim_tpu\b", "madsim_tpu_torch", src)
    src = re.sub(r"\b(from|import) examples\.", r"\1 madsim_tpu_torch.examples.", src)
    for old, new in renames:
        src = re.sub(rf"\b{old}\b", new, src)
    return src


def _load_port(name: str, renames=()) -> types.ModuleType:
    pname = f"_port_{name}"
    mod = sys.modules.get(pname)
    if mod is not None:
        return mod
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        code = compile(port_source(f.read(), renames), path, "exec")
    mod = types.ModuleType(pname)
    mod.__file__ = path
    sys.modules[pname] = mod  # dataclasses and the codec look classes up here
    try:
        exec(code, mod.__dict__)
    except BaseException:
        del sys.modules[pname]
        raise
    return mod


def pair(name: str, renames=()):
    """(reference module, port module) of ``tests/<name>.py``; ``renames``
    are further whole-word substitutions in the port's copy (a protobuf
    package, which one process can compile only once)."""
    return importlib.import_module(name), _load_port(name, renames)


def _is_slow(dec) -> bool:
    return ast.unparse(dec).endswith("mark.slow")


def cases(name: str) -> list:
    """The test functions of ``tests/<name>.py`` in file order, read from
    its syntax tree (collection imports neither package), without the
    ``slow`` ones."""
    with open(os.path.join(TESTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and not any(_is_slow(d) for d in n.decorator_list)]


def _call(fn, tmp_dir):
    params = inspect.signature(fn).parameters
    kwargs = {}
    with pytest.MonkeyPatch.context() as mp:
        for p in params:
            if p == "tmp_path":
                tmp_dir.mkdir(parents=True, exist_ok=True)
                kwargs[p] = tmp_dir
            elif p == "monkeypatch":
                kwargs[p] = mp
            else:
                raise TypeError(f"{fn.__qualname__}: no fixture {p!r} in the parity harness")
        return fn(**kwargs)


def run_case(name: str, case: str, tmp_path, renames=()) -> None:
    """The reference's and the port's run of one test, one after the other."""
    for tag, mod in zip(("reference", "port"), pair(name, renames)):
        before = signal.getsignal(signal.SIGINT)
        _call(getattr(mod, case), tmp_path / tag)
        after = signal.getsignal(signal.SIGINT)
        assert after is before, f"{tag}: SIGINT's handler is {after!r}, not {before!r}"
