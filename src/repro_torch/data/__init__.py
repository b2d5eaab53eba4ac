"""Datasets of the port."""
from repro_torch.data.datasets import (PAPER_DATASETS, STREAM_BLOCK,
                                       DatasetSpec, make_dataset,
                                       make_dataset_numpy,
                                       make_dataset_streamed)

__all__ = ["PAPER_DATASETS", "STREAM_BLOCK", "DatasetSpec", "make_dataset",
           "make_dataset_numpy", "make_dataset_streamed"]
