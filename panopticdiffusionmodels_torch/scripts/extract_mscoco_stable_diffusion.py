"""MS-COCO feature extraction for the SD-scale configs.

    python -m panopticdiffusionmodels_torch.scripts.extract_mscoco_stable_diffusion ...

Port of `scripts/extract_mscoco_stable_diffusion.py` (reference
`scripts/extract_mscoco_stable_diffusion.py`): the pipeline of
`extract_mscoco_feature.py`, with its arguments.  The SD scale factor
(0.18215) is applied at training time from `config.autoencoder.scale_factor`,
so the stored moments are the same; this entry exists for the command line.
"""
from .extract_mscoco_feature import main

if __name__ == "__main__":
    main()
