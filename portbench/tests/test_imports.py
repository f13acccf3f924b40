"""The import walk: nothing under portbench/ imports JAX or the JAX
package (top-level names compared whole), the reference imports nothing of
the port, and nothing the benchmark runs reads the JAX package's bench."""

import ast
import os

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "evennicer_slam_tpu"}


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(cells.PKG_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_whole_name_comparison():
    # the port's name begins with the JAX package's: compared whole, it passes
    assert "evennicer_slam_tpu_torch" not in FORBIDDEN
    assert "evennicer_slam_tpu_torch".split(".")[0] != "evennicer_slam_tpu"


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        mods = set(_imports(path))
        assert "evennicer_slam_tpu_torch" not in mods, path
        assert not mods & FORBIDDEN, path


def test_nothing_reads_the_jax_bench():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        for name in ("bench.py", "BENCH_r", "benchmarks/", "MULTICHIP_r", "BASELINE.json"):
            assert name not in text, (path, name)
