"""Shared by the CLIP test files: the vocabulary corpus and the tiny text
config both packages read.  transformers' image transforms import TensorFlow
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
