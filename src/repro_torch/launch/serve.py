"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Runs the batched serve engine (prefill + decode) on the smoke config of an
architecture, or at its full widths with --full, with weights drawn from
seed 0.  `--rag` puts filtered retrieval in front of generation: a 4,096 x
64 store behind a ScaNN index sharded over a mesh of the cards
(`build_sharded_scann`, `DistributedScannExecutor`), each request
retrieving under its own predicate bitmap; the retrieved rows' tokens
prefix the prompts, and every retrieved id is checked against its bitmap.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (SearchParams, WorkloadSpec, generate_bitmaps,
                              probe_batch, resolve_device)
from repro_torch.core.distributed import (DistributedScannExecutor,
                                          build_sharded_scann)
from repro_torch.data import DatasetSpec, make_dataset
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.serving import RetrievalAugmentedServer, ServeEngine


def rag_retrieve(bundle, params, prompts: np.ndarray, rng, selectivity: float,
                 device):
    """The --rag retrieval: the reference launcher's store, index and
    filters, on `device`.  Returns (RetrievalResult, bitmaps)."""
    dev = resolve_device(device)
    store, _ = make_dataset(DatasetSpec("ragdemo", 4096, 64, "l2",
                                        clusters=16), num_queries=1,
                            device=dev)
    shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = make_mesh((shards,), ("data",))
    sharded = build_sharded_scann(store, mesh, "data", num_leaves=64,
                                  levels=1, device=dev)
    executor = DistributedScannExecutor(sharded)
    sp = SearchParams(k=4, num_leaves_to_search=16)
    doc_tokens = rng.randint(0, bundle.cfg.vocab, (4096, 8)).astype(np.int32)
    server = RetrievalAugmentedServer(bundle, params, executor, sp,
                                      doc_tokens, chunk_len=8)
    queries = torch.as_tensor(rng.randn(prompts.shape[0], 64).astype(
        np.float32), device=dev)
    bitmaps = generate_bitmaps(store, queries,
                               WorkloadSpec(selectivity, "none"), device=dev)
    return server.retrieve(prompts, bitmaps), bitmaps


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--selectivity", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    bundle = build_model(cfg)
    params = bundle.init(0, args.device)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab,
                          (args.batch, args.prompt_len)).astype(np.int32)

    if args.rag:
        res, bitmaps = rag_retrieve(bundle, params, prompts, rng,
                                    args.selectivity, args.device)
        ids = torch.as_tensor(res.ids, device=bitmaps.device)
        passing = bool((probe_batch(bitmaps, ids) | (ids < 0)).all())
        print(f"retrieved ids (filtered, sel={args.selectivity}):")
        print(res.ids)
        print(f"retrieved ids pass their filters: {passing}")
        if not passing:
            raise RuntimeError("a retrieved id fails its filter bitmap")
        prompts = res.tokens
        print("augmented prompt len:", prompts.shape[1])

    engine = ServeEngine(bundle, params,
                         max_seq=prompts.shape[1] + args.max_new,
                         batch_size=args.batch, device=args.device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} tokens in {dt:.1f}s "
          f"({engine.stats.decoded_tokens / dt:.1f} tok/s decode, "
          f"{engine.device})")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
