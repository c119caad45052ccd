"""Data-parallel training and sampling over a torch.distributed group.

Counterpart of ctdd_tpu/parallel/dp.py. Every rank holds the parameters,
optimizer state and EMA in full and a shard of the batch; it computes its
shard's loss and gradients (`train_step.value_and_grad`), the loss and every
gradient go through one all-reduce of a flat bucket followed by a division
by the world size (JAX's `pmean`), and only then does `apply_update` run, so
clipping, Adam, EMA and the non-finite skip see the mean and every rank
takes the same update (or skips it) together. On the one-rank mesh without
a process group the steps take no reduce: the mean of one rank is its own
loss, which the step then reads when its forward ends.
`DistributedDataParallel` is not used: its hooks see `.grad` fields, and
the step takes its gradients with `torch.autograd.grad` on a dict of
parameters.

Randomness: rank r of a step draws from the generator keyed by (seed, step,
r) (`train_step.step_generator`; rank 0 keys as one device does), the
counterpart of `fold_in(fold_in(key, step), r)`; a sampling rank from
`rank_generator(seed, r)` (`fold_in(key, r)`).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ctdd_tpu_torch.parallel.mesh import Mesh
from ctdd_tpu_torch.training.train_step import make_device_data_step, make_train_step


def pmean(mesh: Mesh, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
    """(loss, grads) averaged over the ranks: one all-reduce of a flat
    float32 bucket [loss, every gradient]. The means are copied back into
    the gradient tensors, so that the update reads them with the layout
    (and the alignment, which picks the foreach kernels' summation order)
    of a single-device step."""
    flat = torch.cat([loss.detach().reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads.values()])
    mesh.all_reduce_mean_(flat)
    offset = 1
    for g in grads.values():
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat[0], grads


def _reduce(mesh: Mesh):
    """The steps' `reduce`: `pmean` over the mesh, or None on the one-rank
    mesh without a process group, where it would be the identity."""
    if mesh.backend is None:
        return None
    return lambda v, g: pmean(mesh, v, g)


def make_dp_train_step(model, loss, tx, mesh: Mesh, ema_decay: float = 0.0,
                       has_label: bool = False, augment_fn=None) -> Callable:
    """`step(state, batch, seed, label=None) -> (state, loss)`, where
    `batch` (and `label`, passed with `has_label`) are this rank's shard
    (`shard_batch`) and the returned loss is the mean over the ranks."""
    return make_train_step(model, loss, tx, ema_decay=ema_decay, augment_fn=augment_fn,
                           rank=mesh.rank, reduce=_reduce(mesh))


def make_device_data_train_step(model, loss, tx, mesh: Mesh, batch_size: int,
                                ema_decay: float = 0.0, has_label: bool = False,
                                augment_fn=None) -> Callable:
    """`step(state, data, seed) -> (state, loss)` over a dataset every rank
    holds on its device (an (x, labels) pair with `has_label`): each rank
    draws `batch_size // world` rows, uniform with replacement, from its own
    generator, then all take the same mean-reduced update."""
    per_rank = batch_size // mesh.world
    if per_rank <= 0:
        raise ValueError(f"batch_size {batch_size} must cover the mesh of {mesh.world}")
    return make_device_data_step(model, loss, tx, per_rank, ema_decay=ema_decay,
                                 has_label=has_label, augment_fn=augment_fn,
                                 rank=mesh.rank, reduce=_reduce(mesh))


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator a sampling rank draws from: keyed by (seed, rank)."""
    s = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_dp_sampler(sampler, mesh: Mesh) -> Callable:
    """`sample(model, params, seed, N) -> (N, D) int numpy array` on every
    rank: each runs the sampler's loop on N / world samples from
    `rank_generator(seed, rank)`, and the shards are gathered in rank order.
    On the fused TauL path every step of every rank is one launch of the
    fused tau-leap kernel."""

    def sample(model, params, seed: int, N: int):
        if N % mesh.world:
            raise ValueError(f"N={N} must divide over {mesh.world} ranks")
        gen = rank_generator(seed, mesh.rank, model.device)
        with torch.inference_mode():
            x, _ = sampler._sample_loop(model, params, gen, N // mesh.world)
            out = mesh.all_gather(x)
        return out.cpu().numpy().astype(int)

    return sample
