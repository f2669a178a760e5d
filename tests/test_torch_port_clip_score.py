"""The port's CLIP score (evaluation/clip_score.py) against the JAX package's,
from a tiny random CLIPModel saved to tmp_path with a byte-level vocab.json /
merges.txt:

  * `clip_score` against the JAX `clip_score` on a tiny random CLIPModel:
    the processor resizes with PIL's bicubic on uint8, the port with torch's
    antialiased bicubic in PIL's two passes, each rounded to uint8 values.
    Measured on noise images (32 -> 32, 48 x 40, 40 x 48, 64, 256 -> 32):
    pixels equal but for one uint8 step (1/255 / std ~ 0.015 after
    normalisation) in at most 1.2e-4 of them, scores within 2.4e-7
    relative.  Bars: one uint8 step a pixel, scores 1e-5 relative."""
from torch_port_clip_common import CORPUS, text_config  # first: it turns TensorFlow off

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from transformers import CLIPConfig, CLIPImageProcessor, FlaxCLIPModel  # noqa: E402

from panopticdiffusionmodels_tpu.evaluation import clip_score as jax_clip_score  # noqa: E402
from panopticdiffusionmodels_torch.evaluation import clip_score  # noqa: E402
from panopticdiffusionmodels_torch.models import clip  # noqa: E402


def random_flax_params(model, seed):
    """Seeded numpy weights on the shapes of `model.init_weights`, taken
    abstractly (Flax's own random init runs op by op for ~5 s): kernels,
    embeddings and biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02),
    `logit_scale` the config's initial value."""
    shapes = jax.eval_shape(lambda key: model.init_weights(key, model.input_shape),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "logit_scale" in name:
            return np.full(leaf.shape, model.config.logit_scale_init_value, np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return (base + rng.normal(0, 0.02, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A tiny random CLIPModel both packages read (vision 32 x 32, patch 8)."""
    path = tmp_path_factory.mktemp("clip")
    n = clip.write_synthetic_vocab(str(path), CORPUS, 64)
    cfg = CLIPConfig(text_config=text_config(n, n - 1),
                     vision_config=dict(hidden_size=32, intermediate_size=64,
                                        num_hidden_layers=2, num_attention_heads=4,
                                        image_size=32, patch_size=8),
                     projection_dim=16)
    model = FlaxCLIPModel(cfg, _do_init=False)
    params = random_flax_params(model, 0)
    model.save_pretrained(str(path), params=params)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(str(path))
    torch.save({k: torch.tensor(v) for k, v in clip.flax_to_torch_state_dict(params).items()},
               path / "pytorch_model.bin")
    return str(path)


TEXTS = ["a photo of a cat", "the dog's ball is red", "a cat on the mat", "red"] * 2


@pytest.mark.parametrize("hw", [(32, 32), (48, 40), (40, 48), (64, 64)],
                         ids=["no-resize", "resize-48x40", "resize-40x48", "resize-64"])
def test_clip_score_matches_jax(clip_dir, hw):
    images = np.random.default_rng(hw[0]).integers(0, 256, (8, *hw, 3)).astype(np.uint8)
    ref = jax_clip_score.clip_score(images, TEXTS, version=clip_dir)
    ours = clip_score.clip_score(images, TEXTS, version=clip_dir, device="cpu")
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    processor = CLIPImageProcessor.from_pretrained(clip_dir)
    want = processor(images=list(images), return_tensors="np")["pixel_values"]
    got = clip_score.preprocess(images, clip_score.load_image_config(clip_dir), "cpu")
    std = np.asarray(clip_score.CLIP_STD).min()
    np.testing.assert_allclose(got.numpy(), want, atol=1.0 / 255 / std + 1e-5)


def test_clip_score_from_dirs_pairs_captions(clip_dir, tmp_path):
    from PIL import Image

    samples, captions = tmp_path / "samples", tmp_path / "captions"
    samples.mkdir()
    captions.mkdir()
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    for name, img in zip((0, 1, 10000), images):  # 10000: image 0, caption 1
        Image.fromarray(img).save(samples / f"{name}.png")
    (captions / "0_0_text.txt").write_text("a photo of a cat\n")
    (captions / "0_1_text.txt").write_text("red\n")
    (captions / "1_text.txt").write_text("the dog's ball\n")
    ours = clip_score.clip_score_from_dirs(str(samples), str(captions), version=clip_dir,
                                           device="cpu")
    want = clip_score.clip_score(images[[0, 1, 2]], ["a photo of a cat", "the dog's ball",
                                                     "red"], version=clip_dir, device="cpu")
    np.testing.assert_allclose(ours, want, rtol=1e-6)
