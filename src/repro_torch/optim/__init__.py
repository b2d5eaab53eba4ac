"""The optimizer: AdamW and int8 error-feedback gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           ef_compress_grads)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_int8", "decompress_int8", "ef_compress_grads"]
