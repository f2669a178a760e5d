"""The port's CLIP text side (models/clip.py and `generate(prompts=...)`)
against transformers and the JAX package, from tiny random models saved to
tmp_path with a byte-level vocab.json / merges.txt:

  * the tokenizer against transformers' `CLIPTokenizer`, id for id, on
    ASCII, accented, digit, punctuation, CJK, emoji and special-token prompts;
  * `FrozenCLIPEmbedder.encode` against the JAX `FrozenCLIPEmbedder` on the
    same directory (its weights written by `FlaxCLIPTextModel.save_pretrained`,
    the port's `pytorch_model.bin` by `clip_text_state_dict`), both pooling
    branches, and from a `model.safetensors`: rtol 1e-4 / atol 1e-5;
  * `generate(prompts=...)` on a tiny pipeline against the JAX pipeline with
    the same embedder (its contexts; see the test).

The CLIP score is held to JAX in test_torch_port_clip_score.py."""
import os

from torch_port_clip_common import write_text_dir  # first: it turns TensorFlow off

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from transformers import CLIPTokenizer as HFTokenizer  # noqa: E402

from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config  # noqa: E402
from panopticdiffusionmodels_tpu.models.clip import FrozenCLIPEmbedder as JaxEmbedder  # noqa: E402
from panopticdiffusionmodels_tpu.serving import GenerationPipeline as JaxPipeline  # noqa: E402
from panopticdiffusionmodels_torch.configs import get_config  # noqa: E402
from panopticdiffusionmodels_torch.models import clip, get_nnet  # noqa: E402
from panopticdiffusionmodels_torch.serving import GenerationPipeline  # noqa: E402
PROMPTS = ["A photo of a CAT sitting on the mat.", "Café naïve RÉSUMÉ, über-cool",
           "there are 2 cats and 13 dogs; 3.14159 ½ Ⅻ ²",
           "the dog's ball isn't red!!! ... 'hello' \"quoted\"", "東京タワーの写真 and 北京",
           "emoji 😀👍🏽 party 🎉🎉", "tabs\tand\nnewlines   nbsp ls", "x" * 200,
           "<|endoftext|> inside <|startoftext|>text", "I'M YOU'LL WE'D THEY'RE", ""]


@pytest.fixture(scope="module")
def eos_text_dir(tmp_path_factory):
    return write_text_dir(tmp_path_factory.mktemp("clip_text_eos"), "eos")


@pytest.fixture(scope="module", params=[2, "eos"], ids=["eos2-argmax", "first-eos"])
def text_dir(request, tmp_path_factory):
    if request.param == "eos":
        return request.getfixturevalue("eos_text_dir")
    return write_text_dir(tmp_path_factory.mktemp("clip_text"), request.param)


def test_tokenizer_matches_transformers(text_dir):
    ours, theirs = clip.CLIPTokenizer.from_dir(text_dir), HFTokenizer.from_pretrained(text_dir)
    for p in PROMPTS:
        want = theirs([p], truncation=True, max_length=77, padding="max_length",
                      return_tensors="np")
        got = ours([p], max_length=77)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}: {p!r}")
    want = theirs(PROMPTS[:4], truncation=True, max_length=77, padding=True,
                  return_tensors="np")
    got = ours(PROMPTS[:4], max_length=77, padding="longest")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


def test_embedder_matches_jax(text_dir, tmp_path):
    prompts = PROMPTS[:3] + ["red"]
    ref = JaxEmbedder(version=text_dir).encode(prompts)
    ours = clip.FrozenCLIPEmbedder(text_dir, device="cpu").encode(prompts)
    assert ours.shape == ref.shape == (4, 77, 32)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)
    # the same weights from model.safetensors, read by the port's own reader
    from safetensors.torch import save_file

    for name in ("config.json", "vocab.json", "merges.txt"):
        (tmp_path / name).write_bytes(open(os.path.join(text_dir, name), "rb").read())
    save_file(torch.load(os.path.join(text_dir, "pytorch_model.bin")),
              str(tmp_path / "model.safetensors"))
    again = clip.FrozenCLIPEmbedder(str(tmp_path), device="cpu").encode(prompts)
    torch.testing.assert_close(again, ours, rtol=0, atol=0)


def test_embedder_defaults_to_the_card(text_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clip.FrozenCLIPEmbedder(text_dir)


def test_generate_prompts_matches_jax(eos_text_dir):
    """The JAX pipeline's prompts path is `_pipeline(encode_prompts(prompts))`;
    its sampler on given contexts is held to the port in
    test_torch_port_serving.py, so here the contexts of the two pipelines'
    embedders are compared, and the port's `generate(prompts=)` against its
    own `generate(contexts=)` of them."""
    text = eos_text_dir
    config = get_config("synthetic_tiny")
    config.nnet.clip_dim = 32  # the tiny text model's width
    torch.manual_seed(0)
    kw = dict(config.nnet)
    nnet = get_nnet(kw.pop("name"), **kw)
    empty = np.random.default_rng(1).standard_normal((7, 32)).astype(np.float32)
    pipe = GenerationPipeline(config, nnet, None, empty, device="cpu", clip_path=text)
    prompts = ["a photo of a cat", "the dog's ball"]

    jconfig = jax_get_config("synthetic_tiny")
    jconfig.nnet.clip_dim = 32
    jpipe = JaxPipeline(jconfig, None, None, empty)
    jpipe._clip = JaxEmbedder(version=text, max_length=config.nnet.num_clip_token)
    ctx = pipe.encode_prompts(prompts)
    assert ctx.shape == (2, 7, 32)
    np.testing.assert_allclose(ctx.numpy(), jpipe.encode_prompts(prompts), rtol=1e-4,
                               atol=1e-5)
    by_prompt = pipe.generate(prompts=prompts, steps=3, seed=5)
    by_context = pipe.generate(contexts=ctx.numpy(), steps=3, seed=5)
    for a, b in zip(by_prompt, by_context):
        np.testing.assert_array_equal(a, b)
    batches = list(pipe.generate_batches([{"prompts": prompts}, {"prompts": prompts[:1]}],
                                         steps=3))
    assert [b[0].shape[0] for b in batches] == [2, 1]
