"""The import rule: nothing the benchmark runs is JAX or the JAX package
(top-level names compared whole: ``edgeml_tpu_torch`` begins with
``edgeml_tpu``), and the frozen reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

BANNED = {"jax", "jaxlib", "flax", "edgeml_tpu"}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def files(sub=""):
    for dirpath, _, names in os.walk(os.path.join(harness.HERE, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_no_module_of_the_benchmark_imports_jax():
    for f in files():
        for name in imports(f):
            assert name.split(".")[0] not in BANNED, (f, name)


def test_reference_imports_nothing_of_the_program():
    for f in files("reference"):
        for name in imports(f):
            top = name.split(".")[0]
            assert top not in BANNED | {"edgeml_tpu_torch"}, (f, name)
            assert not name.startswith(("benchmark.families", "benchmark.generators",
                                        "benchmark.harness")), (f, name)


def test_a_run_loads_no_jax(tmp_path):
    """Everything a run imports, in a fresh process: no banned top-level
    name ends up in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness as h, benchmark.trace, benchmark.control\n"
            "import benchmark.families.yolov5, benchmark.families.faster_rcnn\n"
            "import benchmark.generators.directory, benchmark.generators.frames\n"
            "import edgeml_tpu_torch.models.infer\n"
            "print(h.banned_modules())\n") % harness.ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_compare_whole():
    sys.modules.setdefault("edgeml_tpu_torch", __import__("edgeml_tpu_torch"))
    assert "edgeml_tpu_torch" not in harness.banned_modules()
