"""Datasets of the port; importing registers them."""

from ctdd_tpu_torch.data import images as images  # noqa: F401
from ctdd_tpu_torch.data.loaders import ArrayDataset, get_dataset, iterate_batches  # noqa: F401
