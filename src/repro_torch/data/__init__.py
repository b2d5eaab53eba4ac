"""Datasets and the token pipeline of the port."""
from repro_torch.data.datasets import (PAPER_DATASETS, STREAM_BLOCK,
                                       DatasetSpec, make_dataset,
                                       make_dataset_numpy,
                                       make_dataset_streamed)
from repro_torch.data.pipeline import (DataConfig, batch_for_step,
                                       make_data_config, token_batch_specs)

__all__ = ["PAPER_DATASETS", "STREAM_BLOCK", "DatasetSpec", "make_dataset",
           "make_dataset_numpy", "make_dataset_streamed", "DataConfig",
           "batch_for_step", "make_data_config", "token_batch_specs"]
