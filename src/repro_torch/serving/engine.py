"""Batched serving engine: prefill + decode over a KV cache.

The counterpart of the reference's `serving/engine.py`: batched request
handling on top of the model bundle's prefill and decode, greedy or
temperature sampling, stop handling and cache reuse across steps.  It runs
under `torch.inference_mode()`.  On ranks (a bundle whose mesh carries a
process group) every rank is given the global prompts, serves its rows of
them (its data ranks split the batch; heads, ffn hidden dim and experts
add their partials over its `model` ranks; its cache, the bundle's
`init_cache`, holds its rows: every kv head of attention, RWKV6's wkv
and Mamba2's ssm states of its heads where they split whole over
`model` and of every head where its columns cut one, `x_prev` and the
conv states whole), selects each token from its rows' logits of the whole
vocab (the model puts them together over `model`, so argmax's tie rule
and the sampling noise are one process's), stops when every row of the
global batch has, and returns the global tokens.  The engine gathers
every leaf that the layout splits over `data` (fsdp, and every dense
weight under the `sp` scheme) once, when it is made: a decode step would
gather every weight again; the blocks take a leaf so gathered as it is
(`models.layers._Ranks.weight`).  Under the `sp` scheme the prefill
takes the rank's positions of the prompts and every rank reads the last
rank's last position's logits (`layers.last_position`); the decode
steps, which replay the prompt into the cache, keep the sequence whole
on every `model` rank, and the RWKV6 wkv and Mamba2 ssm states hold
every head (`layers.rank_cache`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.api import ModelBundle
from repro_torch.train.ranks import layout


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
        self.ranks = layout(bundle)
        if self.ranks is not None:
            self.params = self.ranks.without_fsdp(params)

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
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64)
        mine = toks
        if self.ranks is not None:
            # a decode step takes every position; under `sp` the prefill
            # takes the rank's
            mine = self.ranks.batch({"tokens": toks})["tokens"]
            toks = self.ranks.batch({"tokens": toks},
                                    positions=False)["tokens"]
        toks = toks.to(dev)
        rows = toks.shape[0]
        logits = self.bundle.prefill(self.params, {"tokens": mine.to(dev)})
        self.stats.prefill_tokens += b * plen
        cache = self.bundle.init_cache(rows, self.max_seq, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # replay the prompt through the decode path to fill the cache
        for t in range(plen):
            _, cache = self.bundle.decode(
                self.params, cache, {"tokens": toks[:, t:t + 1]}, t)
        tok = self._sample(logits, gen)
        out = [tok.cpu().numpy()]
        done = np.zeros(rows, bool)
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
                if self._all(done.all()):
                    break
        out = np.stack(out, axis=1)
        return out if self.ranks is None else self.ranks.rows(out)

    def _all(self, flag) -> bool:
        return bool(flag) if self.ranks is None \
            else self.ranks.all_true(bool(flag))
