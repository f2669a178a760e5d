"""Encode the 12 fixed visualisation prompts.

    python -m panopticdiffusionmodels_torch.scripts.extract_test_prompt_feature \
        --outdir <feature root> --clip <local CLIP directory> [--device cuda|cpu]

Port of `scripts/extract_test_prompt_feature.py` (reference
`scripts/extract_test_prompt_feature.py:14-38`): writes `{outdir}/run_vis/{i}.npy`,
the (77, 768) f32 context of prompt i, which `MSCOCO256Features.contexts`
reads back.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

PROMPTS = [
    "A green train is coming down the tracks.",
    "A group of skiers are preparing to ski down a mountain.",
    "A small kitchen with a low ceiling.",
    "A group of elephants walking in muddy water.",
    "A living area with a television and a table.",
    "A road with traffic lights, street lights and cars.",
    "A bus driving in a city area with traffic signs.",
    "A bathroom with a toilet sink and bathtub.",
    "A stop sign installed on the right of a street.",
    "A zebra standing in a field of tall grass.",
    "A two story house with a balcony and a garage.",
    "A man holding a tennis racket on a tennis court.",
]


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--clip", default="openai/clip-vit-large-patch14")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ..models.clip import FrozenCLIPEmbedder

    contexts = FrozenCLIPEmbedder(args.clip, device=args.device).encode(PROMPTS).cpu().numpy()
    out = os.path.join(args.outdir, "run_vis")
    os.makedirs(out, exist_ok=True)
    for i, ctx in enumerate(contexts):
        np.save(os.path.join(out, f"{i}.npy"), ctx)
    print("saved", len(PROMPTS), "prompt contexts")
    return contexts


if __name__ == "__main__":
    main()
