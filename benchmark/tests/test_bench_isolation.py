"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level module names compared
whole: envgs_tpu_torch begins with envgs_tpu)."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench_tiny import REPO

JAX_SIDE = {"jax", "jaxlib", "flax", "envgs_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted("
         "{m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, 'benchmark/tests')\n"
            "from pathlib import Path\n"
            "from bench_tiny import run, tiny_root\n"
            f"run(tiny_root(Path({str(tmp_path)!r})), 'envgs-train-early')\n"
            "import benchmark.trace\n")
    mods = _loaded(code)
    assert "envgs_tpu_torch" in mods and not mods & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.envgs, "
                   "benchmark.reference.gauss3d, benchmark.reference.losses")
    assert not mods & (JAX_SIDE | {"envgs_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    for p in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in JAX_SIDE | {"envgs_tpu_torch"}, \
                    (p.name, n)
