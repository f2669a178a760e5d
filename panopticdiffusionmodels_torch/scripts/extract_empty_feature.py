"""Encode the empty prompt for classifier-free guidance.

    python -m panopticdiffusionmodels_torch.scripts.extract_empty_feature \
        --outdir <feature root> --clip <local CLIP directory> [--device cuda|cpu]

Port of `scripts/extract_empty_feature.py` (reference
`scripts/extract_empty_feature.py`): writes `{outdir}/empty_context.npy`,
the (77, 768) f32 context of "" from `models/clip.py::FrozenCLIPEmbedder`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--clip", default="openai/clip-vit-large-patch14")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..models.clip import FrozenCLIPEmbedder

    context = FrozenCLIPEmbedder(args.clip, device=args.device).encode([""])[0].cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "empty_context.npy"), context)
    print("saved", context.shape)
    return context


if __name__ == "__main__":
    main()
