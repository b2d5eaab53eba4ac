"""Retrieval-augmented serving: the paper's FVS inside a serving stack.

The counterpart of examples/rag_serving.py: llama3.2-3b's smoke LM paired
with a 4,096-chunk filtered vector store (64-d, 16 clusters) behind a
ScaNN index sharded over a mesh of every card; two requests with their
own predicates (20 % and 5 % selectivity) retrieve 4 chunks each, the
chunks' tokens are spliced in front of the prompts, and the LM generates
12 tokens greedily.

    PYTHONPATH=src python -m repro_torch.rag_serving            # on the card
    PYTHONPATH=src python -m repro_torch.rag_serving --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import (SearchParams, WorkloadSpec, generate_bitmaps,
                              resolve_device)
from repro_torch.core.distributed import (DistributedScannExecutor,
                                          build_sharded_scann)
from repro_torch.data import DatasetSpec, make_dataset
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.serving import RetrievalAugmentedServer, ServeEngine

SEARCH = SearchParams(k=4, num_leaves_to_search=32)
SELECTIVITIES = (0.2, 0.05)


def serve(bundle, params, sharded, docs: np.ndarray, prompts: np.ndarray,
          bitmaps: torch.Tensor, max_new_tokens: int = 12,
          embed_fn: Optional[Callable] = None) -> dict:
    """Retrieve under each request's bitmap over the sharded index, then
    generate from the augmented prompts.  Prints and returns the
    retrieved ids, the augmented prompt length, the generated tokens and
    the decoded-token count."""
    server = RetrievalAugmentedServer(
        bundle, params, DistributedScannExecutor(sharded), SEARCH, docs,
        chunk_len=docs.shape[1], embed_fn=embed_fn)
    res = server.retrieve(prompts, bitmaps)
    print("retrieved ids per request (filtered):", res.ids.tolist())
    print("augmented prompt length:", res.tokens.shape[1])
    engine = ServeEngine(bundle, params,
                         max_seq=res.tokens.shape[1] + max(16, max_new_tokens),
                         batch_size=prompts.shape[0],
                         device=bitmaps.device)
    out = engine.generate(res.tokens, max_new_tokens=max_new_tokens)
    print("generated token ids:", out.tolist())
    print(f"decode throughput: {engine.stats.decoded_tokens} tokens")
    return {"ids": res.ids, "augmented_len": int(res.tokens.shape[1]),
            "tokens": out, "decoded_tokens": engine.stats.decoded_tokens}


def main(device="cuda", n: int = 4096, dim: int = 64, clusters: int = 16,
         num_leaves: int = 64, prompt_len: int = 16, max_new_tokens: int = 12,
         embed_fn: Optional[Callable] = None) -> dict:
    """Build the LM (seed 0), the store, the sharded index over a mesh of
    every card (one position on the CPU), the documents, prompts and the
    two requests' bitmaps, and `serve` them."""
    dev = resolve_device(device)
    cfg = smoke_config("llama3.2-3b")
    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    rng = np.random.RandomState(0)
    store, _ = make_dataset(DatasetSpec("docs", n, dim, "l2",
                                        clusters=clusters), num_queries=1,
                            device=dev)
    docs = rng.randint(0, cfg.vocab, (n, 8)).astype(np.int32)
    shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    sharded = build_sharded_scann(store, make_mesh((shards,), ("data",)),
                                  "data", num_leaves=num_leaves, levels=1,
                                  device=dev)
    prompts = rng.randint(0, cfg.vocab, (2, prompt_len)).astype(np.int32)
    q = torch.as_tensor(rng.randn(2, dim).astype(np.float32), device=dev)
    bitmaps = torch.cat([
        generate_bitmaps(store, q[i:i + 1], WorkloadSpec(sel, "none"),
                         seed=i + 1, device=dev)
        for i, sel in enumerate(SELECTIVITIES)])
    return serve(bundle, params, sharded, docs, prompts, bitmaps,
                 max_new_tokens, embed_fn)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
