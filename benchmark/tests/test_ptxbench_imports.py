"""Nothing the harness or the reference imports is JAX or the JAX
package (top-level names compared whole), and the reference imports
nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import common

HARNESS = ["benchmark.run", "benchmark.common", "benchmark.trace",
           "benchmark.readers", "benchmark.reference", "benchmark.control",
           "benchmark.make_intersect_counts", "benchmark.kinds.frame",
           "benchmark.kinds.inverse"]


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {common.ROOT!r}); {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=common.ROOT)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    metrics = "; ".join(
        f"common.load_module('metrics', {m['name']!r})"
        for m in common.manifest()["per_layer"])
    imports = ("import importlib; from benchmark import common; "
               + "; ".join(f"importlib.import_module({m!r})" for m in HARNESS)
               + "; " + metrics)
    loaded = _loaded_after(imports)
    assert not loaded & set(common.FORBIDDEN), loaded & set(common.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference")
    assert "ptx_torch" not in loaded
    assert not loaded & set(common.FORBIDDEN)
    with open(os.path.join(common.BENCH, "reference.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ptx_torch_lookalike", sys)
    assert "ptx" not in common.forbidden_modules() or "ptx" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in common.forbidden_modules()
