"""Batched serving engine: prefill + decode over a KV cache.

The counterpart of the reference's `serving/engine.py`: batched request
handling on top of the model bundle's prefill and decode, greedy or
temperature sampling, stop handling and cache reuse across steps.  It runs
under `torch.inference_mode()`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.api import ModelBundle


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    steps: int = 0


class ServeEngine:
    def __init__(self, bundle: ModelBundle, params, max_seq: int,
                 batch_size: int, temperature: float = 0.0, device="cuda"):
        self.bundle = bundle
        self.params = params
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.temperature = temperature
        self.device = resolve_device(device)
        self.stats = ServeStats()

    def _sample(self, logits: torch.Tensor, gen: torch.Generator
                ) -> torch.Tensor:
        logits = logits[:, -1, :].to(torch.float32)
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # Gumbel-max, as jax.random.categorical draws; the noise comes from
        # the engine's torch.Generator, so the draws are not the reference's
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(logits / self.temperature - torch.log(-torch.log(u)),
                            dim=-1)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 seed: int = 0, stop_token: Optional[int] = None
                 ) -> np.ndarray:
        """prompts: (B, P) int token ids (uniform length: the engine pads
        batches upstream).  Returns (B, max_new_tokens), fewer columns when
        every row has reached `stop_token`.  Temperature sampling draws
        from a torch.Generator seeded by `seed`: the same seed gives the
        same tokens, but not `jax.random.categorical`'s."""
        b, plen = prompts.shape
        assert b == self.batch_size
        dev = self.device
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=dev)
        logits = self.bundle.prefill(self.params, {"tokens": toks})
        self.stats.prefill_tokens += b * plen
        cache = self.bundle.init_cache(b, self.max_seq, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # replay the prompt through the decode path to fill the cache
        for t in range(plen):
            _, cache = self.bundle.decode(
                self.params, cache, {"tokens": toks[:, t:t + 1]}, t)
        tok = self._sample(logits, gen)
        out = [tok.cpu().numpy()]
        done = np.zeros(b, bool)
        for i in range(max_new_tokens - 1):
            logits, cache = self.bundle.decode(
                self.params, cache, {"tokens": tok[:, None]}, plen + i)
            tok = self._sample(logits, gen)
            self.stats.decoded_tokens += int(b)
            self.stats.steps += 1
            host = tok.cpu().numpy()
            out.append(host)
            if stop_token is not None:
                done |= host == stop_token
                if done.all():
                    break
        return np.stack(out, axis=1)
