"""No chip run may load JAX or the JAX package, compared by whole
top-level names, and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import cell, spec


def test_whole_name_comparison():
    assert cell.forbidden_modules(["amyloid_yolo_tpu_torch", "amyloid_yolo_tpu_torch.ops"]) == []
    assert cell.forbidden_modules(["jaxtyping", "flaxen", "numpy"]) == []
    assert cell.forbidden_modules(["amyloid_yolo_tpu.ops.nms", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["amyloid_yolo_tpu", "flax", "jax",
                                                      "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.harness.cell as c\n"
            "import benchmark.harness.kind_detect, benchmark.harness.kind_train\n"
            "import amyloid_yolo_tpu_torch.detectors, amyloid_yolo_tpu_torch.parallel.steps\n"
            "print(c.forbidden_modules())" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(spec.BENCH_DIR, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("amyloid_yolo_tpu_torch", "amyloid_yolo_tpu",
                                              "jax", "jaxlib", "flax"), (path, name)
