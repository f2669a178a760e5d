"""The port's feature-extraction scripts (`panopticdiffusionmodels_torch/scripts/
extract_*.py`) against the JAX package's (`scripts/extract_*.py`, imported by
path with `scripts/` on sys.path), each `main()` run on the same tiny inputs:

  * a COCO tree written by the test (`torch_port_coco_common.py`), a seeded
    SD-layout KL-VAE .pth at a tiny width (each package's
    `models.vae.get_model` monkeypatched to ch = 32, the SD levels and res
    blocks kept, which the JAX converter reads) at --size 32, and a tiny CLIP
    text directory (`torch_port_clip_common.write_text_dir`);
  * moments and contexts at rtol 1e-4 / atol 1e-5, the ROADMAP parity bar;
    texts, seg maps and labels exactly; the empty and prompt contexts too;
  * the port's `--batch 3` files equal its `--batch 1` files exactly;
  * `MSCOCO256Features` / `MSCOCOFeatureDataset` read the port's COCO output
    and `FeatureDataset` its ImageNet output."""
import importlib.util
import json
import os
import sys
from pathlib import Path

from torch_port_clip_common import write_text_dir  # first: it turns TensorFlow off

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from panopticdiffusionmodels_tpu.models import vae as jax_vae  # noqa: E402
from panopticdiffusionmodels_torch.data.datasets import (  # noqa: E402
    FeatureDataset,
    MSCOCO256Features,
)
from panopticdiffusionmodels_torch.models import vae  # noqa: E402
from panopticdiffusionmodels_torch.scripts import (  # noqa: E402
    extract_empty_feature,
    extract_imagenet_feature,
    extract_mscoco_feature,
    extract_mscoco_stable_diffusion,
    extract_test_prompt_feature,
)
from torch_port_coco_common import IMAGE_IDS, write_coco_tree  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
RTOL, ATOL = 1e-4, 1e-5


def jax_script(name):
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)  # extract_mscoco_stable_diffusion imports its sibling
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, *args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    jax_script(name).main()


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("extract")
    coco = write_coco_tree(tmp / "coco", "train2017", seed=0)
    write_coco_tree(tmp / "coco", "val2017", seed=1)
    torch.manual_seed(0)
    seeded = vae.AutoencoderKL(ch=32)
    with torch.no_grad():  # non-trivial GroupNorm affines
        for name, p in seeded.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    torch.save(seeded.state_dict(), tmp / "autoencoder_kl.pth")
    clip = write_text_dir(tmp / "clip")
    return dict(tmp=tmp, coco=coco, ae=str(tmp / "autoencoder_kl.pth"), clip=clip)


@pytest.fixture
def tiny_vaes(monkeypatch):
    monkeypatch.setattr(vae, "get_model", lambda *a, **k: vae.AutoencoderKL(ch=32))
    monkeypatch.setattr(jax_vae, "get_model", lambda *a, **k: jax_vae.AutoencoderKL(
        ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4, embed_dim=4, out_ch=3))


def coco_args(assets, outdir, split="train2017"):
    return ["--split", split, "--datadir", assets["coco"], "--outdir", str(outdir),
            "--size", str(SIZE), "--autoencoder", assets["ae"], "--clip", assets["clip"]]


@pytest.fixture(scope="module")
def coco_outputs(assets):
    """The port's and JAX's COCO features of both splits, and the port's at
    --batch 1, written once for the module."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(vae, "get_model", lambda *a, **k: vae.AutoencoderKL(ch=32))
        mp.setattr(jax_vae, "get_model", lambda *a, **k: jax_vae.AutoencoderKL(
            ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4, embed_dim=4, out_ch=3))
        tmp = assets["tmp"]
        reports = {}
        for split in ("train2017", "val2017"):
            reports[split] = extract_mscoco_feature.main(
                coco_args(assets, tmp / "port", split) + ["--batch", "3", "--device", "cpu"])
        extract_mscoco_stable_diffusion.main(coco_args(assets, tmp / "port_b1")
                                             + ["--batch", "1", "--device", "cpu"])
        run_jax(mp, "extract_mscoco_feature", *coco_args(assets, tmp / "jax"))
        run_jax(mp, "extract_mscoco_stable_diffusion", *coco_args(assets, tmp / "jax",
                                                                  "val2017"))
    finally:
        mp.undo()
    return dict(port=tmp / "port", port_b1=tmp / "port_b1", jax=tmp / "jax", reports=reports)


def test_mscoco_features_match_jax(coco_outputs):
    for split in ("train", "val"):
        ours, ref = coco_outputs["port"] / split, coco_outputs["jax"] / split
        assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
        n = len(IMAGE_IDS)
        names = {f"{i}.npy" for i in range(n)} | {f"{i}_{k}.npy" for i in range(n)
                                                  for k in range(5)}
        assert names <= set(os.listdir(ours))
        for i in range(n):
            m, jm = np.load(ours / f"{i}.npy"), np.load(ref / f"{i}.npy")
            assert m.dtype == np.float32 and m.shape == jm.shape == (8, SIZE // 8, SIZE // 8)
            np.testing.assert_allclose(m, jm, rtol=RTOL, atol=ATOL, err_msg=f"{split} {i}")
            for k in range(5):
                c, jc = np.load(ours / f"{i}_{k}.npy"), np.load(ref / f"{i}_{k}.npy")
                assert c.dtype == np.float32 and c.shape == (77, 32)
                np.testing.assert_allclose(c, jc, rtol=RTOL, atol=ATOL)
            assert (ours / f"{i}_text.txt").read_text() == (ref / f"{i}_text.txt").read_text()
            has_seg = (ref / f"{i}_seg.npy").exists()
            assert (ours / f"{i}_seg.npy").exists() == has_seg
            if has_seg:
                s, js = np.load(ours / f"{i}_seg.npy"), np.load(ref / f"{i}_seg.npy")
                assert s.dtype == js.dtype == np.int32 and np.array_equal(s, js)
        assert not (ours / f"{sorted(IMAGE_IDS).index(IMAGE_IDS[-1])}_seg.npy").exists()


def test_batched_extraction_equals_one_at_a_time(coco_outputs):
    ours, one = coco_outputs["port"] / "train", coco_outputs["port_b1"] / "train"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(one))
    for name in os.listdir(one):
        if name.endswith(".txt"):
            assert (ours / name).read_text() == (one / name).read_text()
        else:
            assert np.array_equal(np.load(ours / name), np.load(one / name)), name


def test_report_has_the_split(coco_outputs):
    report = coco_outputs["reports"]["train2017"]
    assert report["images"] == len(IMAGE_IDS) and report["images_per_s"] > 0
    parts = report["vae_s"] + report["clip_s"] + report["host_s"]
    assert report["vae_s"] > 0 and report["clip_s"] > 0
    assert parts == pytest.approx(report["seconds"])
    json.dumps(report)


def test_empty_and_prompt_contexts_match_jax(assets, coco_outputs, monkeypatch):
    port, ref = coco_outputs["port"], coco_outputs["jax"]
    for name in ("extract_empty_feature", "extract_test_prompt_feature"):
        getattr(sys.modules[f"panopticdiffusionmodels_torch.scripts.{name}"], "main")(
            ["--outdir", str(port), "--clip", assets["clip"], "--device", "cpu"])
        run_jax(monkeypatch, name, "--outdir", str(ref), "--clip", assets["clip"])
    assert extract_test_prompt_feature.PROMPTS == jax_script("extract_test_prompt_feature").PROMPTS
    empty = np.load(port / "empty_context.npy")
    assert empty.shape == (77, 32)
    np.testing.assert_allclose(empty, np.load(ref / "empty_context.npy"), rtol=RTOL, atol=ATOL)
    assert sorted(os.listdir(port / "run_vis")) == sorted(os.listdir(ref / "run_vis"))
    assert len(os.listdir(port / "run_vis")) == 12
    for i in range(12):
        np.testing.assert_allclose(np.load(port / "run_vis" / f"{i}.npy"),
                                   np.load(ref / "run_vis" / f"{i}.npy"), rtol=RTOL, atol=ATOL)
    # the features read back by the port's datasets
    ds = MSCOCO256Features(str(port), cfg=True, p_uncond=0.2, mask_size=SIZE // 2)
    assert ds.contexts.shape == (12, 77, 32)
    assert len(ds.train) == len(IMAGE_IDS) - 1  # the indices with a seg map
    z, ctx, seg = ds.train[0]
    assert z.shape == (SIZE // 8, SIZE // 8, 8) and ctx.shape == (77, 32)
    assert seg.shape == (SIZE // 2, SIZE // 2, 1) and seg.dtype == np.int32
    *fields, idx = ds.test[1]
    assert idx == ds.test.indices[1]  # the image without a panoptic map has no index
    assert np.array_equal(fields[1], np.load(port / "val" / f"{idx}_0.npy"))
    np.testing.assert_array_equal(fields[0],
                                  np.load(port / "val" / f"{idx}.npy").transpose(1, 2, 0))


def write_imagenet(root):
    rng = np.random.default_rng(4)
    for c, cls in enumerate(("n01", "n02")):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for j, (w, h) in enumerate([(40, 30), (30, 44)][: 2 - c % 2 + 1]):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                d / f"img{j}.JPEG", quality=95)
    return str(root)


def test_imagenet_features_match_jax(assets, tiny_vaes, monkeypatch):
    data = write_imagenet(assets["tmp"] / "imagenet")
    ours, ref = assets["tmp"] / "in_port", assets["tmp"] / "in_jax"
    args = ["--datadir", data, "--size", str(SIZE), "--autoencoder", assets["ae"]]
    n = extract_imagenet_feature.main(args + ["--outdir", str(ours), "--device", "cpu"])
    run_jax(monkeypatch, "extract_imagenet_feature", *args, "--outdir", str(ref))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == sorted(
        f"{i}.npy" for i in range(2 * n))
    ds = FeatureDataset(str(ours))
    assert len(ds) == 2 * n
    for i in range(2 * n):
        m, label = np.load(ours / f"{i}.npy", allow_pickle=True)
        jm, jlabel = np.load(ref / f"{i}.npy", allow_pickle=True)
        assert label == jlabel == (0 if i < 4 else 1)
        np.testing.assert_allclose(np.asarray(m, np.float32), np.asarray(jm, np.float32),
                                   rtol=RTOL, atol=ATOL)
        z, y = ds[i]
        assert y == label and z.shape == (SIZE // 8, SIZE // 8, 8)
    flipped = ds[1][0]
    assert not np.allclose(flipped, ds[0][0])
