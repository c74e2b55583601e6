"""What the benchmark's sources import and open."""
import ast
import os

import pytest

from helpers import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "line3d_tpu"}


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(top_level_imports(os.path.join(ref, f)))
            assert "line3d_tpu_torch" not in names, f
            assert "benchmark" not in names or f == "__init__.py", f


def test_nothing_reads_the_tpu_records():
    for path in sources():
        if os.path.basename(path) == "test_bench_imports.py":
            continue
        text = open(path).read()
        for word in ("bench.py", "BENCH_r", "MULTICHIP_", "BASELINE"):
            assert word not in text, (path, word)
