"""The training step: loss -> grads -> non-finite skip -> clip -> Adam -> EMA.

Counterpart of ctdd_tpu/training/train_step.py, run eagerly. Randomness:
each step derives its generator, and the seed of the device's default
generator that dropout draws from, from (seed, state.step), the
counterpart of `fold_in(key, state.step)`, so a resumed run replays the
draws of an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.training.state import TrainState

NAN_SENTINEL = 1e9  # reference training.py:24


def make_loss_fn(model, loss):
    """(params, batch, generator, label, n_iter) -> scalar loss, dropout on."""

    def loss_fn(params, batch, generator, label, n_iter):
        return loss.calc_loss(model, params, generator, batch, label=label,
                              n_iter=n_iter, train=True)

    return loss_fn


def value_and_grad(fn: Callable, params: Dict[str, torch.Tensor]):
    """fn(params) -> scalar; returns (value, grads keyed like params). A
    parameter that the loss does not reach (a frozen weight the forward
    detaches) gets a zero gradient, as under JAX's stop_gradient."""
    value = fn(params)
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return value.detach(), dict(zip(params, grads))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator on `device`; seeds the device's default
    generator (dropout) from the same (seed, step) pair."""
    device = torch.device(device)
    s_draw, s_dropout = (int(s) for s in
                         np.random.SeedSequence([seed, step]).generate_state(2))
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(s_dropout)
    else:
        torch.default_generator.manual_seed(s_dropout)
    return torch.Generator(device=device).manual_seed(s_draw)


@torch.no_grad()
def apply_update(state: TrainState, loss, grads, tx, ema_decay: float):
    """Optimizer and EMA update with the non-finite skip: on a non-finite
    loss params, optimizer state and EMA stay as they are, `step` still
    advances, and the 1e9 sentinel is returned. Updates the tensors in place
    (the returned state shares them); reading the loss waits for the device.
    Returns (state, loss as a float)."""
    value = float(loss)
    if not math.isfinite(value):
        return dataclasses.replace(state, step=state.step + 1), NAN_SENTINEL
    opt_state = tx.update(state.params, grads, state.opt_state)
    n_updates = state.ema_num_updates
    if ema_decay > 0.0:
        n_updates = state.ema_update(state.params, ema_decay)
    return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1,
                               ema_num_updates=n_updates), value


def make_train_step(model, loss, tx, ema_decay: float = 0.0) -> Callable:
    """`step(state, batch, seed, label=None) -> (state, loss)` over a batch
    the caller supplies."""
    loss_fn = make_loss_fn(model, loss)

    def step(state: TrainState, batch, seed: int, label=None):
        gen = step_generator(seed, state.step, batch.device)
        value, grads = value_and_grad(
            lambda p: loss_fn(p, batch, gen, label, state.step), state.params)
        return apply_update(state, value, grads, tx, ema_decay)

    return step


def make_device_data_step(model, loss, tx, batch_size: int,
                          ema_decay: float = 0.0) -> Callable:
    """`step(state, data, seed) -> (state, loss)` over a dataset on the
    device, (N, D) int: the batch indices are drawn on the device, uniform
    with replacement, from the step's generator."""
    loss_fn = make_loss_fn(model, loss)

    def step(state: TrainState, data, seed: int):
        gen = step_generator(seed, state.step, data.device)
        idx = torch.randint(0, data.shape[0], (batch_size,), generator=gen,
                            device=data.device)
        batch = data[idx]
        value, grads = value_and_grad(
            lambda p: loss_fn(p, batch, gen, None, state.step), state.params)
        return apply_update(state, value, grads, tx, ema_decay)

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
