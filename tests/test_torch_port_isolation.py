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
# the modules of the evaluation and CLIP slice, which the walk must reach
EVAL_MODULES = ["panopticdiffusionmodels_torch." + m for m in (
    "evaluation.inception", "evaluation.fid", "evaluation.kid", "evaluation.mask_metrics",
    "evaluation.sampler_io", "evaluation.runner", "evaluation.clip_score", "models.clip",
    "utils.misc")]
# the modules of the UNet-family slice and the rest of the zoo, which the walk must reach
UNET_MODULES = ["panopticdiffusionmodels_torch." + m for m in (
    "models.unet", "samplers.pndm", "utils.ldm_bridge", "configs.mscoco_unet",
    "configs.mscoco_unet_512", "configs.imagenet256_uvit_huge",
    "configs.imagenet512_uvit_huge")]
# the modules of the data-parallel slice and the trainer's branches (the
# multi-process loader, async checkpoints, Adam, every remat policy,
# pallas_recompute, sp U-ViT), which the walk must reach
DDP_MODULES = ["panopticdiffusionmodels_torch." + m for m in (
    "parallel.mesh", "data.loader", "cli", "train.trainer", "train.checkpoint",
    "train.state", "models.layers", "ops.attention", "models.uvit", "models.uvit_t2i")]
# the modules of the data slice and FSDP (the COCO database, the native
# loader, the extraction and conversion scripts, the sharding), which the
# walk must reach
DATA_MODULES = ["panopticdiffusionmodels_torch." + m for m in (
    "data.mscoco", "data.native_loader", "parallel.sharding", "ops.kernels.build",
    "scripts.extract_mscoco_feature", "scripts.extract_mscoco_stable_diffusion",
    "scripts.extract_imagenet_feature", "scripts.extract_empty_feature",
    "scripts.extract_test_prompt_feature", "scripts.convert_checkpoint")]
# packages the port must not come to need: CLIP's tokenizer and weights are read
# by its own code
NOT_LOADED = ("transformers", "flax", "regex", "ftfy", "safetensors")

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
print("EVAL:", all(m in sys.modules for m in {EVAL_MODULES!r}))
print("UNET:", all(m in sys.modules for m in {UNET_MODULES!r}))
print("DDP:", all(m in sys.modules for m in {DDP_MODULES!r}))
print("DATA:", all(m in sys.modules for m in {DATA_MODULES!r}))
print("LOADED:", sorted(m for m in sys.modules if m.split(".")[0] in {NOT_LOADED!r}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN: []" in out.stdout, out.stdout
    assert int(out.stdout.split("MODULES:")[1].split()[0]) >= 15
    assert "PIXEL: True" in out.stdout, out.stdout
    assert "EVAL: True" in out.stdout, out.stdout
    assert "UNET: True" in out.stdout, out.stdout
    assert "DDP: True" in out.stdout, out.stdout
    assert "DATA: True" in out.stdout, out.stdout
    assert "LOADED: []" in out.stdout, out.stdout


def test_port_sources_name_no_jax_import():
    for path in list((ROOT / "panopticdiffusionmodels_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, (path, line)


def test_native_loader_source_is_the_ports_own():
    """The port builds its own copy of the C++ loader, never `native/`'s."""
    from panopticdiffusionmodels_torch.data import native_loader

    assert native_loader.SOURCE.is_relative_to(ROOT / "panopticdiffusionmodels_torch")
