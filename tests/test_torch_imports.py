"""The PyTorch port imports neither ``jax`` nor anything of the JAX package."""

import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "amyloid_yolo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "amyloid_yolo_tpu")
# the training path's modules, which the scans below must reach
TRAINING_MODULES = ("ops.boxes", "models.heads", "ops.targets", "ops.loss", "models.darknet",
                    "ops.bnstats",
                    "ops.augment", "parallel.steps", "io.datasets", "ops.metrics",
                    "evaluate", "utils.logging", "io.weights", "training")
# the serving path and the CLI's modules
SERVING_MODULES = ("serving", "cli", "cli.main", "io.tiles", "analysis", "analysis.validation",
                   "domain")
# data and spatial parallelism: the mesh, the multi-process step, height sharding
PARALLEL_MODULES = ("parallel.mesh", "parallel.distributed", "parallel.spatial")
# the study: the prospective validation, its figures, the data checks, the cfgs
STUDY_MODULES = ("analysis.prospective", "analysis.plots", "analysis.data_checks",
                 "config.make_cfg")
SCRIPTS = ("chip_smoke", "bench_k2")  # the port's scripts at the repo root
EXAMPLES = ("run_study_torch", "native_res_training_torch")  # the port's scripts under examples/


def _port_files():
    files = [os.path.join(REPO, f"{m}.py") for m in SCRIPTS]
    files += [os.path.join(REPO, "examples", f"{m}.py") for m in EXAMPLES]
    for root, _, names in os.walk(os.path.join(REPO, PKG)):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _port_modules():
    mods = []
    for path in _port_files()[len(SCRIPTS) + len(EXAMPLES):]:
        if path.endswith("__main__.py"):  # runs the CLI when imported
            continue
        mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'examples')!r})\n"
        f"for m in {_port_modules() + list(SCRIPTS) + list(EXAMPLES)!r}: "
        "importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_module():
    """Static scan: no import of, and no dotted module string naming, jax or
    the JAX package (file paths such as ``amyloid_yolo_tpu/pallas/...`` in
    documentation are not module references)."""
    found = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                names = [node.value] if " " not in node.value.strip() else []
            found += [(os.path.relpath(path, REPO), n) for n in names if _forbidden(n.strip())]
    assert not found, found
    assert len(_port_files()) > 15
    mods = set(_port_modules())
    assert {f"{PKG}.{m}" for m in TRAINING_MODULES + SERVING_MODULES + PARALLEL_MODULES
            + STUDY_MODULES} <= mods
    for m in EXAMPLES:
        assert os.path.join(REPO, "examples", f"{m}.py") in _port_files()
    assert os.path.join(REPO, PKG, "cli", "__main__.py") in _port_files()


def test_port_builds_and_reads_nothing_in_the_jax_package():
    """No file of the port (Python, CUDA or C++ source) names a path into the
    JAX package, and the tile reader's source, build directory and library
    lie inside the port."""
    pattern = re.compile(r"amyloid_yolo_tpu(?!_torch)")
    found = []
    for root, _, names in os.walk(os.path.join(REPO, PKG)):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh", ".cc")):
                with open(os.path.join(root, n)) as fh:
                    found += [(n, m.group(0)) for m in pattern.finditer(fh.read())]
    assert not found, found
    from amyloid_yolo_tpu_torch.io import native

    port = os.path.join(REPO, PKG) + os.sep
    for p in (native.SOURCE, native.BUILD_DIR + os.sep, native.library_path()):
        assert os.path.abspath(p).startswith(port), p
    assert os.path.exists(native.SOURCE)
