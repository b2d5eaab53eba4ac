"""Training loop: the step factory and the fault-tolerant driver.

The counterpart of the reference's `train/loop.py`.  Fault-tolerance
contract:
  * data is a pure function of (config, step): a restart replays exactly;
  * checkpoints are atomic and asynchronous (CheckpointManager), by
    cadence, with the reference's leaf names: a checkpoint written by
    either package's Trainer restores in the other's;
  * on restart the Trainer resumes from the latest step, onto the device
    it is asked for or laid out by `shardings` on another mesh (elastic:
    `restore_checkpoint` reshards);
  * a per-step deadline hook flags stragglers, with an injectable clock.

A bundle whose mesh carries a process group (`build_model(cfg, mesh)`,
one rank a position) trains on the ranks (`train.ranks.RankLayout`):
each rank takes its rows of the global batch, its gradients are summed
over its data ranks, the clip's norm and the int8 scale span the blocks
of a split leaf, AdamW updates the rank's blocks; `Trainer` places a
fresh init or restores each rank's block, and rank 0 writes the global
tree that it gathers from every rank's blocks.

The step is eager PyTorch: the gradients come from `torch.autograd.grad`
over the params' leaves, so the forward is the models' own (with their
remat); no hand kernel is on this path (the reference's losses never
reach a Pallas kernel).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.models.api import ModelBundle
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    ef_compress_grads
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import init_error_buffers
from repro_torch.train.ranks import layout


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1              # gradient accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    step_deadline_s: float = 0.0       # 0 = no deadline (straggler hook off)
    grad_compression: bool = False     # int8 error-feedback DP compression
    log_every: int = 10


def _trainable(p: torch.Tensor) -> torch.Tensor:
    if not p.is_floating_point():
        raise TypeError(f"a {p.dtype} parameter has no gradient")
    return p.detach().requires_grad_(True)


def value_and_grad(loss_fn: Callable, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """(loss, grads) of `loss_fn(params, batch)`, the grads shaped as
    `params` (zeros for a leaf the loss does not use) and neither holding
    autograd history."""
    ps = tree_map(_trainable, params)
    with torch.enable_grad():
        loss = loss_fn(ps, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(ps),
                                         allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), ps)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig,
                    train_cfg: TrainConfig,
                    donate: bool = True) -> Callable:
    """Returns fn: (params, opt_state, batch) -> (params, opt_state,
    metrics).  With microbatches > 1, `batch` leaves carry a leading
    (microbatches, ...) axis and the grads are accumulated in f32, in
    order.  With `donate` the update is written into the given params and
    optimizer state (the reference's donated buffers); else they are left
    as they are.  `batch` may hold numpy arrays: they go to the params'
    device.  On ranks (`bundle.mesh` with a process group) `batch` is the
    global batch and `params` / `opt_state` each rank's blocks."""
    ranks = layout(bundle)

    def step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        if ranks is not None:
            batch = ranks.batch(batch, train_cfg.microbatches > 1)
        batch = _on(batch, dev)
        if train_cfg.microbatches > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(train_cfg.microbatches):
                lo, g = value_and_grad(bundle.loss, params,
                                       {k: v[i] for k, v in batch.items()})
                tree_map(torch.Tensor.add_, grads, g)
                loss = loss + lo
                del g
            scale = 1.0 / train_cfg.microbatches
            tree_map(lambda g: g.mul_(scale), grads)
            loss = loss * scale
        else:
            loss, grads = value_and_grad(bundle.loss, params, batch)

        split = None
        if ranks is not None:
            ranks.reduce(grads)
            split = ranks.split(grads)
        if train_cfg.grad_compression:
            grads, err = ef_compress_grads(grads, opt_state["ef_error"],
                                           split)
        new_params, new_inner, metrics = adamw_update(
            params, grads, opt_state["adamw"], opt_cfg, donate=donate,
            split=split)
        new_state = {"adamw": new_inner}
        if train_cfg.grad_compression:
            new_state["ef_error"] = err
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return step


def init_opt_state(bundle: ModelBundle, params: Any, opt_cfg: AdamWConfig,
                   train_cfg: TrainConfig) -> dict:
    state = {"adamw": adamw_init(params, opt_cfg)}
    if train_cfg.grad_compression:
        state["ef_error"] = init_error_buffers(params)
    return state


class Trainer:
    """Fault-tolerant driver around the step."""

    def __init__(self, bundle: ModelBundle, opt_cfg: AdamWConfig,
                 train_cfg: TrainConfig,
                 batch_fn: Callable[[int], Any],
                 clock: Callable[[], float] = time.monotonic):
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.batch_fn = batch_fn
        self.clock = clock
        self.step_fn = make_train_step(bundle, opt_cfg, train_cfg)
        self.ranks = layout(bundle)
        self.ckpt = (CheckpointManager(train_cfg.checkpoint_dir)
                     if train_cfg.checkpoint_dir else None)
        self.stragglers: list[int] = []
        self.history: list[dict] = []

    def init_or_restore(self, key, device="cuda",
                        shardings: Optional[Any] = None):
        """(params, opt_state, start step): fresh from `key` (a seed or a
        torch.Generator), or the latest checkpoint's, on `device`; a
        restore lays its leaves out by `shardings` ({"params": ...,
        "opt": ...}, see `restore_checkpoint`) where it is given.  On
        ranks each rank holds its blocks (`RankLayout`): of the fresh init
        (every rank draws the whole tree from `key`), or of the
        checkpoint that rank 0 finds last."""
        params = self.bundle.init(key, device)
        if self.ranks is not None:
            params = self.ranks.place(params)
        opt_state = init_opt_state(self.bundle, params, self.opt_cfg,
                                   self.cfg)
        start = 0
        if self.ckpt:
            last = latest_step(self.ckpt.directory)
            if self.ranks is not None:
                last = self.ranks.broadcast_int(last)
            if last is not None:
                tree = {"params": params, "opt": opt_state}
                if shardings is None and self.ranks is not None:
                    shardings = self.ranks.shardings(tree)
                tree, _ = restore_checkpoint(self.ckpt.directory, last, tree,
                                             shardings=shardings)
                params, opt_state = tree["params"], tree["opt"]
                start = last
        return params, opt_state, start

    def run(self, params, opt_state, start_step: int = 0,
            fail_at: Optional[int] = None):
        """fail_at injects a crash (tests exercise restart-and-replay).
        Each step ends in a synchronize on the card, so the deadline hook
        reads the step's device time too."""
        cuda = tree_leaves(params)[0].device.type == "cuda"
        step = start_step
        while step < self.cfg.steps:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = self.clock()
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            if cuda:
                torch.cuda.synchronize()
            dt = self.clock() - t0
            if self.cfg.step_deadline_s and dt > self.cfg.step_deadline_s:
                self.stragglers.append(step)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.steps:
                self.history.append({"step": step,
                                     "loss": float(metrics["loss"]),
                                     "grad_norm": float(
                                         metrics["grad_norm"]),
                                     "sec": dt})
            if self.ckpt and (step % self.cfg.checkpoint_every == 0
                              or step == self.cfg.steps):
                self._save(step, {"params": params, "opt": opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state

    def _save(self, step: int, tree: Any) -> None:
        """An asynchronous checkpoint; on ranks, rank 0 writes the global
        tree gathered from every rank's blocks (the gather runs here, on
        every rank)."""
        if self.ranks is not None:
            tree = self.ranks.gather(tree)
            if tree is None:
                return
        self.ckpt.save_async(step, tree)
