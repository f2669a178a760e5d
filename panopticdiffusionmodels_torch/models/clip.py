"""CLIP: the frozen text encoder of `generate(prompts=...)` and the two towers
of the CLIP score, read from a local directory.

Port of `panopticdiffusionmodels_tpu/models/clip.py` (reference
`libs/clip.py:13-38`), which wraps transformers' Flax CLIP.  Here the
modules compute what transformers' `CLIPTextModel` / `CLIPModel` compute,
with their parameter names (`text_model.embeddings.token_embedding.weight`,
`text_model.encoder.layers.0.self_attn.q_proj.weight`, `vision_model.*`,
`visual_projection.weight`, `text_projection.weight`, `logit_scale`), so a
hub directory's `pytorch_model.bin` or `model.safetensors` loads as it is:

  * `CLIPTokenizer`: the byte-level BPE of `vocab.json` / `merges.txt` on
    transformers' path without `ftfy` (its `BasicTokenizer`: control
    characters dropped, whitespace cleaned, CJK characters spaced, NFC,
    lower case), the pre-tokenizer pattern
    `[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (and the contractions) as a
    scanner over `unicodedata.category`, `<|startoftext|>` ... `<|endoftext|>`,
    truncation and padding;
  * `CLIPTextTransformer`: token + position embeddings, pre-LN blocks
    (`quick_gelu` MLP), a causal mask and the padding mask of
    `attention_mask`, the final LayerNorm; `last_hidden_state` and the
    pooled EOS row (argmax of the ids when the config's `eos_token_id` is 2,
    else the first EOS, as transformers 4.57);
  * `CLIPVisionTransformer`: patch conv, class token, pre-LN, the same
    blocks, post-LN on the class row;
  * `FrozenCLIPEmbedder.encode(texts)` -> (B, 77, width) last_hidden_state.

Attention is `F.scaled_dot_product_attention` with the combined mask: the
JAX package runs CLIP as plain XLA, no kernel of its own.  Entry points run
on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.weights import load_safetensors

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                     num_hidden_layers=12, num_attention_heads=8, max_position_embeddings=77,
                     hidden_act="quick_gelu", layer_norm_eps=1e-5, eos_token_id=49407)
VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                       num_attention_heads=12, num_channels=3, image_size=224, patch_size=32,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5)
CLIP_DEFAULTS = dict(projection_dim=512, logit_scale_init_value=2.6592)


# --- tokenizer -------------------------------------------------------------


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def basic_clean(text: str) -> str:
    """transformers' `BasicTokenizer(strip_accents=False, do_split_on_punc=False)`,
    joined by spaces: control characters and U+FFFD dropped, whitespace to
    one space, CJK characters spaced, NFC, lower case."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace, else 'P' (the pattern's
    `[^\\s\\p{L}\\p{N}]`)."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def pretokenize(text: str) -> List[str]:
    """re.findall of CLIP's pattern `<|startoftext|>|<|endoftext|>|'s|'t|'re|
    've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (IGNORECASE), as a
    scanner: at each position the first alternative that matches, else the
    position is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        special = next((s for s in (BOS, EOS) + CONTRACTIONS
                        if text[i:i + len(s)].lower() == s), None)
        if special is not None:
            out.append(text[i:i + len(special)])
            i += len(special)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # a number is one character; letters and the rest run on
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """transformers' (slow) `CLIPTokenizer` without `ftfy`, from a local
    `vocab.json` and `merges.txt`."""

    def __init__(self, vocab_file: str, merges_file: str, pad_token: str = EOS):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: [BOS], EOS: [EOS]}
        self.bos_id, self.eos_id = self.encoder[BOS], self.encoder[EOS]
        self.pad_id = self.encoder[pad_token]

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        """vocab.json + merges.txt, and the pad token of special_tokens_map.json
        or tokenizer_config.json when the directory has one."""
        pad = EOS
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    tok = json.load(f).get("pad_token", pad)
                pad = tok["content"] if isinstance(tok, dict) else tok or pad
        return cls(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), pad)

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = list(word)
        return self.cache[token]

    def tokenize(self, text: str) -> List[int]:
        """Text -> BPE ids, without BOS / EOS.  `<|startoftext|>` and
        `<|endoftext|>` in the text are split out first, as transformers' added
        tokens."""
        ids = []
        pieces = [text]
        for special in (BOS, EOS):
            pieces = [q for p in pieces for q in _split_keep(p, special)]
        for piece in pieces:
            if piece in (BOS, EOS):
                ids.append(self.encoder[piece])
                continue
            for token in pretokenize(basic_clean(piece)):
                token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder.get(t, self.encoder[EOS]) for t in self.bpe(token))
        return ids

    def __call__(self, texts: List[str], max_length: int = 77,
                 padding: str = "max_length") -> Dict[str, np.ndarray]:
        """{'input_ids', 'attention_mask'} (B, L) int64: BOS + ids + EOS,
        truncated to max_length, padded with the pad id to max_length
        (`padding='max_length'`) or to the longest row (`padding='longest'`)."""
        rows = [[self.bos_id] + self.tokenize(t)[:max_length - 2] + [self.eos_id]
                for t in texts]
        width = max_length if padding == "max_length" else max(map(len, rows))
        ids = np.full((len(rows), width), self.pad_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _split_keep(text: str, sep: str) -> List[str]:
    parts = text.split(sep)
    out = []
    for i, p in enumerate(parts):
        if i:
            out.append(sep)
        if p:
            out.append(p)
    return out


# --- modules ---------------------------------------------------------------

_ACTS = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
         "gelu": F.gelu, "gelu_new": lambda x: F.gelu(x, approximate="tanh")}


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim)
                                                                for _ in range(4))

    def forward(self, x, mask=None):
        b, l, c = x.shape
        split = lambda t: t.view(b, l, self.heads, c // self.heads).transpose(1, 2)  # noqa: E731
        o = F.scaled_dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                           split(self.v_proj(x)), attn_mask=mask)
        return self.out_proj(o.transpose(1, 2).reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.act = _ACTS[act]
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        dim, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(dim, cfg["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.mlp = CLIPMLP(dim, cfg["intermediate_size"], cfg["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg["num_hidden_layers"]))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               cfg["hidden_size"])

    def forward(self, ids):
        return self.token_embedding(ids) + self.position_embedding.weight[:ids.shape[1]]


class CLIPTextTransformer(nn.Module):
    """transformers' `CLIPTextTransformer`: forward(input_ids, attention_mask)
    -> (last_hidden_state (B, L, D), pooled (B, D))."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = {**TEXT_DEFAULTS, **cfg}
        self.embeddings = CLIPTextEmbeddings(self.cfg)
        self.encoder = CLIPEncoder(self.cfg)
        self.final_layer_norm = nn.LayerNorm(self.cfg["hidden_size"],
                                             eps=self.cfg["layer_norm_eps"])

    def forward(self, input_ids, attention_mask=None):
        b, l = input_ids.shape
        keep = torch.ones((l, l), dtype=torch.bool, device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            keep = keep & attention_mask.bool()[:, None, None, :]
        x = self.final_layer_norm(self.encoder(self.embeddings(input_ids), keep))
        if self.cfg["eos_token_id"] == 2:  # configs from before transformers PR 24773
            eos = input_ids.to(torch.int).argmax(-1)
        else:
            eos = (input_ids == self.cfg["eos_token_id"]).to(torch.int).argmax(-1)
        return x, x[torch.arange(b, device=x.device), eos]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        dim, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(dim))
        self.patch_embedding = nn.Conv2d(cfg["num_channels"], dim, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg["image_size"] // p) ** 2 + 1, dim)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], 1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    """transformers' `CLIPVisionTransformer`: forward(pixels NCHW, normalised)
    -> the post-LayerNorm class row (B, D)."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = {**VISION_DEFAULTS, **cfg}
        dim, eps = self.cfg["hidden_size"], self.cfg["layer_norm_eps"]
        self.embeddings = CLIPVisionEmbeddings(self.cfg)
        self.pre_layrnorm = nn.LayerNorm(dim, eps=eps)  # transformers' spelling
        self.encoder = CLIPEncoder(self.cfg)
        self.post_layernorm = nn.LayerNorm(dim, eps=eps)

    def forward(self, pixels):
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    """Both towers, their projections and `logit_scale` (transformers'
    `CLIPModel`)."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        cfg = {**CLIP_DEFAULTS, **cfg}
        self.text_model = CLIPTextTransformer(cfg.get("text_config") or {})
        self.vision_model = CLIPVisionTransformer(cfg.get("vision_config") or {})
        proj = cfg["projection_dim"]
        self.visual_projection = nn.Linear(self.vision_model.cfg["hidden_size"], proj,
                                           bias=False)
        self.text_projection = nn.Linear(self.text_model.cfg["hidden_size"], proj, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(float(cfg["logit_scale_init_value"])))

    def image_embeds(self, pixels):
        return self.visual_projection(self.vision_model(pixels))

    def text_embeds(self, input_ids, attention_mask=None):
        return self.text_projection(self.text_model(input_ids, attention_mask)[1])


# --- weights ---------------------------------------------------------------


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a local model directory: `pytorch_model.bin`
    (torch.load, weights only), else `model.safetensors`."""
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return load_safetensors(st_path)
    raise FileNotFoundError(f"{path!r} holds neither pytorch_model.bin nor model.safetensors")


def _load_strict(module: nn.Module, sd: Mapping, prefix: str, what: str):
    """Load the `prefix`ed entries of sd into module, strictly; transformers'
    non-persistent `position_ids` buffers are dropped."""
    own = {k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and not k.endswith("position_ids")}
    if not own:
        raise ValueError(f"{what}: no '{prefix}*' weights in the file")
    module.load_state_dict(own, strict=True)


def flax_to_torch_state_dict(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A transformers Flax parameter tree (numpy) -> the torch module's state
    dict: `kernel` -> `weight` (Dense transposed, Conv HWIO -> OIHW),
    `scale` / `embedding` -> `weight`, other leaves as they are."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flax_to_torch_state_dict(v, name + "."))
            continue
        v = np.asarray(v)
        if k == "kernel":
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
        if k in ("kernel", "scale", "embedding"):
            name = f"{prefix}weight"
        out[name] = np.ascontiguousarray(v)
    return out


def clip_text_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """`FlaxCLIPTextModel.params` (numpy; {'text_model': ...}) -> a
    `pytorch_model.bin` state dict (`text_model.*`) for FrozenCLIPEmbedder."""
    return {k: torch.tensor(v) for k, v in flax_to_torch_state_dict(flax_params).items()}


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    return device


class FrozenCLIPEmbedder:
    """encode(texts) -> (B, max_length, width) last_hidden_state, f32 on the
    embedder's device; from a local directory with config.json, vocab.json,
    merges.txt and pytorch_model.bin or model.safetensors (a CLIPTextModel's
    or a whole CLIPModel's: its text tower is read)."""

    def __init__(self, version: str, max_length: int = 77, device="cuda"):
        self.device = _device(device)
        self.tokenizer = CLIPTokenizer.from_dir(version)
        cfg = read_config(version)
        self.transformer = CLIPTextTransformer(cfg.get("text_config", cfg))
        _load_strict(self.transformer, load_weights(version), "text_model.",
                     f"FrozenCLIPEmbedder({version!r})")
        self.transformer.to(self.device, torch.float32).eval().requires_grad_(False)
        self.max_length = max_length

    @torch.no_grad()
    def encode(self, texts: List[str]) -> torch.Tensor:
        batch = self.tokenizer(list(texts), max_length=self.max_length)
        ids, mask = (torch.as_tensor(batch[k], device=self.device)
                     for k in ("input_ids", "attention_mask"))
        return self.transformer(ids, mask)[0]


def load_clip_model(version: str, device="cuda") -> CLIPModel:
    """A whole CLIPModel from a local directory, strictly."""
    model = CLIPModel(read_config(version))
    sd = {k: v for k, v in load_weights(version).items() if not k.endswith("position_ids")}
    model.load_state_dict(sd, strict=True)
    return model.to(_device(device), torch.float32).eval().requires_grad_(False)


def write_synthetic_vocab(path: str, corpus: str, n_merges: int = 64) -> int:
    """Write a byte-level `vocab.json` / `merges.txt` to `path`: the 256 byte
    symbols with and without `</w>`, `n_merges` merges learned greedily from
    `corpus` (the most frequent adjacent pair first), then the BOS and EOS
    tokens.  For tests and smoke runs without CLIP's own files; returns the
    vocabulary size."""
    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    enc = bytes_to_unicode()
    words = [tuple("".join(enc[b] for b in w.encode("utf-8"))) for w in
             pretokenize(basic_clean(corpus))]
    words = [w[:-1] + (w[-1] + "</w>",) for w in words]
    merges = []
    for _ in range(n_merges):
        counts: Dict[tuple, int] = {}
        for w in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        first, second = max(sorted(counts), key=counts.get)
        merges.append(f"{first} {second}")
        vocab.append(first + second)
        new_words = []
        for w in words:
            merged, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == (first, second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(w[i])
                    i += 1
            new_words.append(tuple(merged))
        words = new_words
    vocab += [BOS, EOS]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return len(vocab)
