"""The training step: loss -> grads -> non-finite skip -> clip -> Adam -> EMA.

Counterpart of ctdd_tpu/training/train_step.py, run eagerly. Randomness:
each step derives its generator, and the seed of the device's default
generator that dropout draws from, from (seed, state.step), the
counterpart of `fold_in(key, state.step)`, so a resumed run replays the
draws of an uninterrupted one. A data-parallel rank r > 0 keys them by
(seed, state.step, r) (`fold_in(fold_in(key, step), r)`); rank 0 keys as
one device does. The builders take that rank and a `reduce(loss, grads)`
that runs between the gradients and the update (parallel/dp.py passes the
mean all-reduce on a mesh of several ranks).

The non-finite skip reads the loss on the host. Without a reduce the loss
is final when the forward ends, so the step copies it to the host right
then (`_EarlyLoss`) and the read waits for the forward alone: the update
is launched while the backward is still queued on the device. After a
reduce the read waits for the reduced loss, behind the whole backward.
`LOSS_READS` counts the steps' reads of each kind.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.training.state import TrainState
from ctdd_tpu_torch.utils.trace import (TRAIN_BACKWARD, TRAIN_DRAW, TRAIN_LOSS,
                                        TRAIN_LOSS_READ, TRAIN_REDUCE, TRAIN_UPDATE, span)

NAN_SENTINEL = 1e9  # reference training.py:24

# the train steps' loss reads in this process: copied when the forward
# ended, or read after a reduce
LOSS_READS = {"after_forward": 0, "after_reduce": 0}


def make_loss_fn(model, loss, augment_fn=None):
    """(params, batch, generator, label, n_iter) -> scalar loss, dropout on.
    `augment_fn(generator, batch)` (data/augment.py) transforms the batch on
    its device, from the step's generator, before the loss draws."""

    def loss_fn(params, batch, generator, label, n_iter):
        if augment_fn is not None:
            batch = augment_fn(generator, batch)
        return loss.calc_loss(model, params, generator, batch, label=label,
                              n_iter=n_iter, train=True)

    return loss_fn


def value_and_grad(fn: Callable, params: Dict[str, torch.Tensor], after_forward=None):
    """fn(params) -> scalar; returns (value, grads keyed like params). A
    parameter that the loss does not reach (a frozen weight the forward
    detaches) gets a zero gradient, as under JAX's stop_gradient.
    `after_forward(value)`, where given, gets the detached value between
    the forward and the backward."""
    with span(TRAIN_LOSS):
        value = fn(params)
    if after_forward is not None:
        after_forward(value.detach())
    with span(TRAIN_BACKWARD):
        grads = torch.autograd.grad(value, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
    return value.detach(), dict(zip(params, grads))


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The step's generator on `device`; seeds the device's default
    generator (dropout) from the same (seed, step) pair, or (seed, step,
    rank) on a data-parallel rank above 0."""
    device = torch.device(device)
    entropy = [seed, step] + ([rank] if rank else [])
    s_draw, s_dropout = (int(s) for s in
                         np.random.SeedSequence(entropy).generate_state(2))
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(s_dropout)
    else:
        torch.default_generator.manual_seed(s_dropout)
    return torch.Generator(device=device).manual_seed(s_draw)


class _EarlyLoss:
    """A step's loss taken when its forward ends; `float()` reads it. On a
    CUDA device `take` enqueues a non-blocking copy into a pinned host
    scalar and records an event behind it, so the read waits for the
    forward and the copy alone, not for the backward launched after them;
    elsewhere it keeps the loss itself. One per step builder: every step
    reuses the scalar, and reads it before the next step copies into it."""

    def __init__(self):
        self._host = self._event = self._value = self._wait = None

    def take(self, value: torch.Tensor) -> None:
        LOSS_READS["after_forward"] += 1
        if value.device.type != "cuda":
            self._value, self._wait = value, None
            return
        if self._host is None:
            self._host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            self._event = torch.cuda.Event()
        self._host.copy_(value, non_blocking=True)
        self._event.record(torch.cuda.current_stream(value.device))
        self._value, self._wait = self._host, self._event

    def __float__(self) -> float:
        if self._wait is not None:
            self._wait.synchronize()
        return float(self._value)


@torch.no_grad()
def apply_update(state: TrainState, loss, grads, tx, ema_decay: float):
    """Optimizer and EMA update with the non-finite skip: on a non-finite
    loss params, optimizer state and EMA stay as they are, `step` still
    advances, and the 1e9 sentinel is returned. Updates the tensors in place
    (the returned state shares them). `float(loss)` waits for the device: a
    tensor for everything queued before it; the steps' `_EarlyLoss` for the
    forward and its copy alone. Returns (state, loss as a float)."""
    with span(TRAIN_LOSS_READ):
        value = float(loss)
    with span(TRAIN_UPDATE):
        if not math.isfinite(value):
            return dataclasses.replace(state, step=state.step + 1), NAN_SENTINEL
        opt_state = tx.update(state.params, grads, state.opt_state)
        n_updates = state.ema_num_updates
        if ema_decay > 0.0:
            n_updates = state.ema_update(state.params, ema_decay)
    return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1,
                               ema_num_updates=n_updates), value


def _finish_step(state: TrainState, loss_fn, batch, gen, label, tx, ema_decay: float,
                 reduce, early: _EarlyLoss) -> tuple:
    """What every step does once it has its batch and generator: the loss
    and its gradients, `reduce` where given, then `apply_update`. Without
    `reduce` the update reads the loss `early` took when the forward ended;
    with it, the reduced loss, once the backward and the reduce are done."""
    value, grads = value_and_grad(
        lambda p: loss_fn(p, batch, gen, label, state.step), state.params,
        after_forward=early.take if reduce is None else None)
    if reduce is None:
        return apply_update(state, early, grads, tx, ema_decay)
    with span(TRAIN_REDUCE):
        value, grads = reduce(value, grads)
    LOSS_READS["after_reduce"] += 1
    return apply_update(state, value, grads, tx, ema_decay)


def make_train_step(model, loss, tx, ema_decay: float = 0.0, augment_fn=None, *,
                    rank: int = 0, reduce=None) -> Callable:
    """`step(state, batch, seed, label=None) -> (state, loss)` over a batch
    the caller supplies. `rank` keys the step's draws (`step_generator`);
    `reduce(loss, grads) -> (loss, grads)`, where given, runs before the
    update."""
    loss_fn = make_loss_fn(model, loss, augment_fn)
    early = _EarlyLoss()

    def step(state: TrainState, batch, seed: int, label=None):
        with span(TRAIN_DRAW):
            gen = step_generator(seed, state.step, batch.device, rank)
        return _finish_step(state, loss_fn, batch, gen, label, tx, ema_decay, reduce, early)

    return step


def make_device_data_step(model, loss, tx, batch_size: int, ema_decay: float = 0.0,
                          has_label: bool = False, augment_fn=None, *,
                          rank: int = 0, reduce=None) -> Callable:
    """`step(state, data, seed) -> (state, loss)` over a dataset on the
    device, (N, D) int: the batch indices are drawn on the device, uniform
    with replacement, from the step's generator. With `has_label`, `data`
    is an (x, labels) pair gathered with the same indices. `rank` and
    `reduce` as `make_train_step`'s."""
    loss_fn = make_loss_fn(model, loss, augment_fn)
    early = _EarlyLoss()

    def step(state: TrainState, data, seed: int):
        x = data[0] if has_label else data
        with span(TRAIN_DRAW):
            gen = step_generator(seed, state.step, x.device, rank)
            idx = torch.randint(0, x.shape[0], (batch_size,), generator=gen, device=x.device)
            batch = x[idx]
            label = data[1][idx] if has_label else None
        return _finish_step(state, loss_fn, batch, gen, label, tx, ema_decay, reduce, early)

    return step


@registry.train_steps.register
class Standard:
    """Registry wrapper so cfg.training.train_step_name resolves."""

    def __init__(self, cfg):
        self.cfg = cfg

    def build(self, model, loss, tx):
        return make_train_step(
            model, loss, tx, ema_decay=float(self.cfg.model.get("ema_decay", 0.0))
        )


def get_train_step(cfg):
    return registry.train_steps.get(cfg.training.train_step_name)(cfg)
