"""Runnable scripts of the port (`python -m panopticdiffusionmodels_torch.scripts.<name>`)."""
