"""Model serving.  The retrieval-augmented server (`serving/rag.py`) and
continuous batching wait for ROADMAP 1.10."""
from repro_torch.serving.engine import ServeEngine, ServeStats

__all__ = ["ServeEngine", "ServeStats"]
