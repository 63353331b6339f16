"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: every module under
``portbench/`` and ``madsim_tpu_torch/`` parsed, each import's top-level
name compared whole (the port's name begins with the JAX package's)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "madsim_tpu"}


def _modules(top):
    for root, dirs, files in os.walk(os.path.join(REPO, top)):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _top_names(path):
    """Top-level names of every absolute import in the file (relative
    imports stay inside their package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0], node.lineno


@pytest.mark.parametrize("top", ["portbench", "madsim_tpu_torch"])
def test_no_jax_and_no_jax_package(top):
    bad = [(os.path.relpath(p, REPO), line, name) for p in _modules(top)
           for name, line in _top_names(p) if name in FORBIDDEN]
    assert not bad, bad


def _escapes(path, top):
    """Relative imports of ``path`` that resolve above directory ``top``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    here = os.path.dirname(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = here
            for _ in range(node.level - 1):
                base = os.path.dirname(base)
            if os.path.commonpath([base, top]) != top:
                yield node.lineno


def test_reference_imports_nothing_of_the_program():
    top = os.path.join(REPO, "portbench", "reference")
    bad = [(os.path.relpath(p, REPO), line, name) for p in _modules(top)
           for name, line in _top_names(p)
           if name in FORBIDDEN | {"madsim_tpu_torch", "portbench"}]
    bad += [(os.path.relpath(p, REPO), line, "relative import out of the reference")
            for p in _modules(top) for line in _escapes(p, top)]
    assert not bad, bad


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import madsim_tpu_torch.engine\nfrom madsim_tpu.engine import core\n"
                   "import jaxlib\nimport jaxtyping\n")
    names = [n for n, _ in _top_names(str(src)) if n in FORBIDDEN]
    assert names == ["madsim_tpu", "jaxlib"]
