from .datasets import DatasetFactory, get_dataset
from .loader import Loader, prefetch_to_device
