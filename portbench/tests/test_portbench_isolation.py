"""Nothing the benchmark runs loads JAX, its libraries or the JAX package
(compared by whole top-level names: `cistar_tpu_torch` is the port), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from _portbench_small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cistar_tpu"}

RUN = """
import sys, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from _portbench_small import run
for name in {cells!r}:
    run(name)
    run(name, trace=True)
from portbench import harness
from portbench import control  # noqa: F401
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in {forbidden!r})))
"""


def test_a_run_loads_no_jax():
    import json
    cells = [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    code = RUN.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"),
                      cells=cells, forbidden=sorted(FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_names_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "cistar_tpu_torch" not in tops and not tops & FORBIDDEN
        assert tops <= {"__future__", "contextlib", "typing", "torch"}, tops
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.p2phd; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cistar_tpu_torch', 'cistar_tpu', 'jax'}))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
