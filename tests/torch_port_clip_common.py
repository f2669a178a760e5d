"""Shared by the CLIP test files: the vocabulary corpus, the tiny text
config both packages read, and `write_text_dir`, a directory holding such a
model.  transformers' image transforms import TensorFlow
when it is installed (~9 s); neither package uses it, so this module turns it
off before transformers is imported."""
import os

os.environ.setdefault("USE_TF", "0")

CORPUS = ("a photo of a cat sitting on the mat. the dog's ball is red; there are 2 cats "
          "and 13 dogs! cafe naive resume")


def text_config(n_vocab, eos):
    return dict(vocab_size=n_vocab, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=77, eos_token_id=eos,
                bos_token_id=n_vocab - 2, pad_token_id=n_vocab - 1)


def write_text_dir(path, eos_kind="eos"):
    """A directory holding a tiny CLIP text model both packages read: the Flax
    weights, and the port's pytorch_model.bin carried from them."""
    import jax
    import numpy as np
    import torch
    from transformers import CLIPTextConfig, FlaxCLIPTextModel

    from panopticdiffusionmodels_torch.models import clip

    n = clip.write_synthetic_vocab(str(path), CORPUS, 64)
    eos = n - 1 if eos_kind == "eos" else 2
    model = FlaxCLIPTextModel(CLIPTextConfig(**text_config(n, eos)), seed=0)
    model.save_pretrained(str(path))
    params = jax.tree.map(np.asarray, model.params)
    torch.save(clip.clip_text_state_dict(params), path / "pytorch_model.bin")
    return str(path)
