"""Serving: the batched LM engine, the retrieval-augmented server with its
degradation ladder (`serving/rag.py`) and continuous batching over the
stepped frontier engine (`serving/continuous.py`)."""
from repro_torch.serving.engine import ServeEngine, ServeStats
from repro_torch.serving.continuous import (ContinuousServer, FairQueue,
                                            Request, SlotPool,
                                            results_in_order)
from repro_torch.serving.rag import (LadderRung, RetrievalAugmentedServer,
                                     admission_floor, bucket_deadline,
                                     default_ladder, price_ladder)

__all__ = ["ServeEngine", "ServeStats", "RetrievalAugmentedServer",
           "LadderRung", "admission_floor", "bucket_deadline",
           "default_ladder", "price_ladder", "ContinuousServer", "FairQueue",
           "Request", "SlotPool", "results_in_order"]
