"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Runs the batched serve engine (prefill + decode) on the smoke config of an
architecture, or at its full widths with --full, with weights drawn from
seed 0.  `--rag` (filtered retrieval in front of generation) serves from a
mesh-sharded ScaNN store (`build_sharded_scann` behind
`DistributedScannExecutor`), which waits for the sharding port (ROADMAP
1.12); `serving.RetrievalAugmentedServer` itself is ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine

RAG_ITEM = ("--rag serves from a mesh-sharded ScaNN store "
            "(build_sharded_scann, DistributedScannExecutor), which is not "
            "ported yet: ROADMAP 1.12 (sharding)")


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.rag:
        raise NotImplementedError(RAG_ITEM)
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    bundle = build_model(cfg)
    params = bundle.init(0, args.device)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab,
                          (args.batch, args.prompt_len)).astype(np.int32)
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
