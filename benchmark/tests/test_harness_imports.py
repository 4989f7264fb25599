"""Nothing the benchmark holds or loads is of the JAX stack, and the
yardstick (reference, scenes, judges) loads nothing of the port."""
import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ros_vision_tpu"}
YARDSTICK = ["reference", "scenes", "judges",
             "harness/stats.py", "harness/roofline.py",
             "harness/camera.py", "harness/nt4_server.py",
             "harness/msgpack_mini.py"]


def imported(path):
    """Top-level names of every import in a file, compared whole."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_file_imports_the_jax_stack(path):
    assert not set(imported(path)) & FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_port():
    for part in YARDSTICK:
        p = ROOT / "benchmark" / part
        for f in ([p] if p.is_file() else sorted(p.rglob("*.py"))):
            assert "ros_vision_tpu_torch" not in set(imported(f)), f


def test_the_yardstick_loads_nothing_of_the_port():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.harness import cell, stats, roofline\n"
        "from benchmark.reference import control, oracle, render\n"
        "cell.load_module('scenes', 'tags3d')\n"
        "cell.load_module('judges', 'tags')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"ros_vision_tpu_torch"})


def test_a_run_loads_nothing_of_the_jax_stack(tiny_root):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import run\n"
        "args = run.parse(['--workload', 'tiny-sync', '--seed', '7',\n"
        "                  '--seconds', '1', '--trace', '0'])\n"
        f"out = run.measure(args, Path({str(tiny_root)!r}), device='cpu')\n"
        "print(json.dumps([out['result']['correct'],\n"
        "                  run.forbidden_modules()]))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tiny_root, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, found = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and found == []


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "ros_vision_tpu_torch_x", sys)
    assert "ros_vision_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]
