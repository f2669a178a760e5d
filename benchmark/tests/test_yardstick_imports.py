"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; names are compared whole (the
program's package name begins with the JAX package's)."""
import ast
import subprocess
import sys

from benchmark import harness

PROGRAM = "panopticdiffusionmodels_torch"


def imported(path):
    """Top-level names of every module that the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(*parts):
    return sorted(p for p in harness.BENCH.joinpath(*parts).rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = imported(path)
        assert PROGRAM not in names and not names & set(harness.FORBIDDEN), path
        assert names <= {"__future__", "math", "numpy", "torch"}, (path, names)


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "panopticdiffusionmodels_tpu_extra", sys)
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax"]


def test_a_run_loads_no_jax():
    """A fresh interpreter that imports the harness, every driver, family,
    dataset and metric, and the program's modules a run uses."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run, calibrate\n"
        "from benchmark.drivers import generate, train\n"
        "from benchmark.families import uvit, uvit_t2i\n"
        "from benchmark.datasets import mscoco256_features, imagenet256_features\n"
        "import panopticdiffusionmodels_torch.serving\n"
        "import panopticdiffusionmodels_torch.train.trainer\n"
        "for m in harness.spec()['per_layer']: harness.metric_reader(m['name'])\n"
        "print(harness.forbidden_modules())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
