"""Datasets of the port."""
from repro_torch.data.datasets import (PAPER_DATASETS, DatasetSpec,
                                       make_dataset, make_dataset_numpy)

__all__ = ["PAPER_DATASETS", "DatasetSpec", "make_dataset",
           "make_dataset_numpy"]
