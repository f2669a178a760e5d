"""Evaluation of the port: sampling to directories, mask metrics, FID / KID
on the FID Inception, and the CLIP score (the port of
`panopticdiffusionmodels_tpu/evaluation/`)."""
