"""Nothing under ``benchmark/`` imports JAX, its libraries or the JAX
package, and ``benchmark/reference/`` imports nothing of the measured
program either. Top-level module names are compared whole: the port's
``uemda_tpu_torch`` begins with the JAX package's ``uemda_tpu``."""

import ast
import os

from bench_helpers import ROOT
from benchmark.harness.device import FORBIDDEN, forbidden_loaded

BENCH = os.path.join(ROOT, "benchmark")


def imported_tops(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def sources(top: str):
    for root, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_nothing_imports_jax_or_the_jax_package():
    bad = [(p, n, line) for p in sources(BENCH)
           for n, line in imported_tops(p) if n in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p, n, line) for p in sources(os.path.join(BENCH, "reference"))
           for n, line in imported_tops(p)
           if n in FORBIDDEN or n == "uemda_tpu_torch"
           or (n == "benchmark" and "reference" not in open(p).read())]
    assert not bad
    for p in sources(os.path.join(BENCH, "reference")):
        for node in ast.walk(ast.parse(open(p).read())):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("benchmark."):
                assert node.module.startswith("benchmark.reference"), p


def test_the_check_compares_top_level_names_whole():
    assert forbidden_loaded({"uemda_tpu_torch": 1, "uemda_tpu_torch.ops": 1,
                             "jaxtyping": 1}) == []
    assert forbidden_loaded({"uemda_tpu.config": 1, "jax.numpy": 1}) == \
        ["jax", "uemda_tpu"]
