"""Restartable training loop + train step factory.

Port of ``repro.train.trainer``.  ``make_train_step`` builds the step:
gradients by ``torch.autograd.grad`` over every param leaf (a leaf the
loss does not reach raises, so no gradient goes missing quietly),
microbatched accumulation, the AdamW update, metrics.  ``Trainer`` owns
the run loop: checkpoint/restart (resume is exact: the data pipeline is a
pure function of step), straggler detection (per-step wall vs the rolling
median, logged and counted) and a failure-injection hook for the
fault-tolerance tests.

The reference jits the step and donates the state; the port runs eagerly
and the step is functional (a new state each step, the old one
untouched).  ``remat`` stays a compile-time choice of the reference with
no eager counterpart: activations are kept (llama3.2-1b at batch 8 x 256
trains on one 80 GB card without it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_step(loss_fn: Callable[[Any, Dict], torch.Tensor],
                    optimizer: AdamW, *, num_microbatches: int = 1,
                    decay: Any = None):
    """loss_fn(params, batch) -> scalar.  Returns train_step(state, batch).

    With ``num_microbatches > 1`` the batch's leading dim is split and the
    loss and grads accumulate in float32 (bfloat16 under a bf16 optimizer
    state), microbatch by microbatch, as the reference's ``lax.scan``
    does; with one, the grads stay in the param dtype.  ``decay`` is the
    per-leaf weight-decay mask ``AdamW.update`` takes
    (``model_zoo.decay_mask(cfg)``).
    """

    def value_and_grad(params, batch):
        leaves, treedef = tree_lib.flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_lib.unflatten(treedef, live), batch)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_lib.unflatten(treedef, list(grads))

    def compute_grads(params, batch):
        if num_microbatches == 1:
            return value_and_grad(params, batch)

        def split(x):
            b = x.shape[0]
            if b % num_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{num_microbatches} microbatches")
            return x.reshape(num_microbatches, b // num_microbatches,
                             *x.shape[1:])

        mbs = tree_lib.tree_map(split, batch)
        acc_dt = (torch.bfloat16 if optimizer.state_dtype == "bfloat16"
                  else torch.float32)
        g_acc = tree_lib.tree_map(lambda p: torch.zeros(
            p.shape, dtype=acc_dt, device=p.device), params)
        dev = tree_lib.flatten(params)[0][0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(num_microbatches):
            mb = tree_lib.tree_map(lambda x: x[i], mbs)
            loss, g = value_and_grad(params, mb)
            g_acc = tree_lib.tree_map(lambda a, b: a + b.to(acc_dt), g_acc, g)
            loss_acc = loss_acc + loss
        inv = 1.0 / num_microbatches
        return (loss_acc * inv,
                tree_lib.tree_map(lambda g: g * inv, g_acc))

    def train_step(state: TrainState, batch: Dict):
        loss, grads = compute_grads(state.params, batch)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params,
                                              decay)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr": optimizer.schedule(opt.step), "step": opt.step}
        return TrainState(params, opt), metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Restartable loop around a train step."""

    train_step: Callable
    batch_for_step: Callable[[int], Dict]   # step -> batch on the device
    state: TrainState
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    # test hook: raise at a given step to simulate a node failure
    failure_at_step: Optional[int] = None

    step: int = 0
    straggler_events: int = 0
    _times: list = dataclasses.field(default_factory=list)

    def maybe_restore(self) -> bool:
        """Restore the latest checkpoint, after any pending async write
        (the reference reads ``LATEST`` without waiting, so a restart right
        after a failure may miss the step being written)."""
        if not self.ckpt_dir:
            return False
        ckpt_lib.wait()
        try:
            self.state, self.step = ckpt_lib.restore(
                self.ckpt_dir, self.state)
            self.step = int(self.step)
            return True
        except FileNotFoundError:
            return False

    def run(self, num_steps: int, log: Callable[[str], None] = print
            ) -> Dict[str, float]:
        last = {}
        target = self.step + num_steps
        while self.step < target:
            if self.failure_at_step is not None and \
                    self.step == self.failure_at_step:
                self.failure_at_step = None  # fail once
                raise RuntimeError(f"injected failure at step {self.step}")
            t0 = time.perf_counter()
            batch = self.batch_for_step(self.step)
            self.state, metrics = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._times.append(dt)
            med = float(np.median(self._times[-50:]))
            if len(self._times) > 5 and dt > self.straggler_factor * med:
                self.straggler_events += 1
                log(f"[straggler] step {self.step}: {dt:.3f}s vs median "
                    f"{med:.3f}s")
            self.step += 1
            if self.step % self.log_every == 0:
                log(f"step {self.step}: loss={metrics['loss']:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} {dt:.3f}s/step")
            # the final step is saved synchronously below: an async save of
            # it too would write the same directory twice, concurrently
            if (self.ckpt_dir and self.step % self.ckpt_every == 0
                    and self.step < target):
                ckpt_lib.save_async(self.ckpt_dir, self.step, self.state)
                ckpt_lib.gc_old(self.ckpt_dir, self.keep_ckpts)
            last = metrics
        if self.ckpt_dir:
            ckpt_lib.save(self.ckpt_dir, self.step, self.state)
            ckpt_lib.gc_old(self.ckpt_dir, self.keep_ckpts)
        return last
