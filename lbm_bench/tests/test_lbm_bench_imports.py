"""Nothing the command runs loads jax, jaxlib, flax or the JAX package,
compared by the whole top-level name; the reference imports nothing of
the program under test."""

import ast
import os
import pathlib
import subprocess
import sys

from lbm_bench import manifest, run

BENCH = manifest.ROOT / "lbm_bench"


def imported(path: pathlib.Path) -> set[str]:
    """The top-level names a source file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "latticeboltzmann_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert set(run.forbidden_modules()) <= set(run.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()


def test_the_reference_imports_only_torch_and_numpy():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "dataclasses", "numpy", "torch"}, path


def test_no_benchmark_source_names_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & set(run.FORBIDDEN), path


def test_a_run_loads_none_of_them(tmp_path):
    """A tiny cell end to end in a fresh process, then sys.modules."""
    code = (
        "import sys, lbm_bench_tiny as tiny\n"
        "from lbm_bench import run\n"
        "import lbm_bench.control, lbm_bench.reference.d2q9\n"
        f"root = tiny.make_root(__import__('pathlib').Path({str(tmp_path)!r}))\n"
        "for name in tiny.TINY:\n"
        "    assert tiny.run(root, name, seconds=0.1, traced=True)['correct'], name\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(manifest.ROOT), str(BENCH / "tests"),
                              os.environ.get("PYTHONPATH", "")])})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, lbm_bench.reference.d2q9\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('latticeboltzmann')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=manifest.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
