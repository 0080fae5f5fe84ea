"""Nothing the benchmark runs loads JAX, the JAX package the port was
made from (``repro``: top-level names compared whole, so ``repro_torch``
is not it) or its ``benchmarks``; the reference loads nothing of the
port."""

import ast
import subprocess
import sys
from pathlib import Path

from bench.harness import env

BENCH = Path(__file__).resolve().parents[1]
REFERENCE_MAY_IMPORT = ("bench.reference", "bench.data")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if "_build" not in p.parts]


def test_no_source_imports_jax_repro_or_benchmarks():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in env.FORBIDDEN, (path, name)


def test_forbidden_names_are_compared_whole():
    assert env.forbidden_loaded(["repro_torch", "repro_torch.models",
                                 "jaxtyping", "benchmark"]) == []
    assert env.forbidden_loaded(["repro.core", "jax", "benchmarks.common"]
                                ) == ["benchmarks.common", "jax",
                                      "repro.core"]


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert not name.startswith(env.PORT), (path, name)
            if name.startswith("bench"):
                assert name.startswith(REFERENCE_MAY_IMPORT), (path, name)
    for path in (BENCH / "data").glob("*.py"):
        for name in _imports(path):
            assert not name.startswith(("bench.harness", env.PORT)), path


def test_no_source_reads_the_jax_benchmarks():
    for path in _sources():
        if path.name == Path(__file__).name:
            continue
        assert "benchmarks/" not in path.read_text(), path


def test_a_run_loads_none_of_them(tmp_path):
    code = f"""
import sys, torch
sys.path.insert(0, {str(env.ROOT)!r})
from bench.harness import env
env.prepare()
from pathlib import Path
from bench.tests import tiny
from bench.harness.cell import load_cell
from bench.run import run_cell
root = tiny.make(Path({str(tmp_path)!r}))
for w in ("enrich.tiny-dense.serve", "train.tiny-moe.feed"):
    line, _ = run_cell(load_cell(w, root), 3, 0.5, False,
                       torch.device("cpu"), 0.0)
    assert line["correct"], line
print("LOADED", env.forbidden_loaded())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout, p.stdout[-2000:]
