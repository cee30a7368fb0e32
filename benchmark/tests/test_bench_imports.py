"""What the benchmark loads: no JAX and no JAX package on the chip's path,
and nothing of the program in the reference.  Top-level names (before the
first dot) are compared whole: the port's name begins with the JAX
package's."""
import ast
import os
import subprocess
import sys

from benchmark.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "fresco_tpu"}


def _imports(path: str) -> set[str]:
    """Top-level names of every module that ``path`` imports."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts: str):
    for d, _, files in os.walk(os.path.join(core.BENCH_DIR, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_reference_imports_neither_jax_nor_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"fresco_torch"}), (path, names)


def test_no_benchmark_source_imports_jax():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_loaded_modules_of_a_run(tiny):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = (
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.harness import core\n"
        f"tiny = json.loads({repr(__import__('json').dumps(tiny))})\n"
        "core.run(core.load_json('BENCHMARK.json'), 'sd15_hed_music.keyframes', 3, 0.5, True, torch.device('cpu'),"
        " overrides=tiny)\n"
        "print(json.dumps(core.forbidden_modules()))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'fresco_torch')[:3]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] != "[]"  # the program ran


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fresco_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert core.forbidden_modules() == [m for m in core.forbidden_modules() if m.split(".")[0] in FORBIDDEN]
    assert "fresco_tpu_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fresco_tpu.x", object())
    assert "fresco_tpu.x" in core.forbidden_modules()
