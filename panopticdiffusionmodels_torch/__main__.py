"""`python -m panopticdiffusionmodels_torch train|eval|sample --config=...` (see cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
