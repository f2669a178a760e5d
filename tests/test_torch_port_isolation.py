"""The port and chip_smoke.py import neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_collections", "absl", "panopticdiffusionmodels_tpu")
# the modules of the pixel-space slice, which the walk below must reach
PIXEL_MODULES = ["panopticdiffusionmodels_torch." + m for m in (
    "diffusion.sde", "samplers.euler_maruyama", "configs.cifar10_uvit_small",
    "configs.imagenet64_uvit_mid")]

PROBE = f"""
import importlib, pkgutil, sys
import panopticdiffusionmodels_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("FORBIDDEN:", bad)
print("MODULES:", sum(m.startswith(pkg.__name__) for m in sys.modules))
print("PIXEL:", all(m in sys.modules for m in {PIXEL_MODULES!r}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN: []" in out.stdout, out.stdout
    assert int(out.stdout.split("MODULES:")[1].split()[0]) >= 15
    assert "PIXEL: True" in out.stdout, out.stdout


def test_port_sources_name_no_jax_import():
    for path in list((ROOT / "panopticdiffusionmodels_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, (path, line)
