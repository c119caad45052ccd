"""Named spans at the port's layer boundaries, for `torch.profiler` traces.

`span(name)` is a `torch.profiler.record_function` range while a profiler
is recording and a shared no-op context manager otherwise: a range costs
microseconds to open, the check of the profiler's flag a fraction of one,
so the spans cost nothing measurable while no one traces. The ranges sit on
the same Kineto timeline as the device's kernels, so a trace charges each
kernel to the span that launched it (the benchmark's `h100bench/spans.py`;
`train --profile-steps` writes such a trace).

Every span the port opens is named in `SPANS`:

- `ctdd.network`: every network forward (`DiffusionModel.apply`).
- `ctdd.train.draw`: the step's generator, batch indices and gather.
- `ctdd.train.loss`: the loss's forward (augmentation, `calc_loss`), with
  `ctdd.network` inside it.
- `ctdd.train.backward`: the host's time in `torch.autograd.grad`.
- `ctdd.train.reduce`: the data-parallel mean of the loss and gradients.
- `ctdd.train.loss_read`: the host reading the loss, which waits for the
  device.
- `ctdd.train.update`: the non-finite skip, clip, Adam and EMA.
- `ctdd.sample.step`: one sampler step or corrector step; what it holds
  beside its child spans is the state update.
- `ctdd.sample.tables`: the forward process's (S, S) tables at one time.
- `ctdd.sample.denoise`: the final argmax, with `ctdd.network` inside it.
- `ctdd.data.pool_wait`: the training loop waiting for a fresh data pool.

A train step has no span of its own: the layer spans are its outermost
ranges, so an idle gap of the device is named by the layer the host was in.
"""

from __future__ import annotations

import contextlib

import torch

NETWORK = "ctdd.network"
TRAIN_DRAW = "ctdd.train.draw"
TRAIN_LOSS = "ctdd.train.loss"
TRAIN_BACKWARD = "ctdd.train.backward"
TRAIN_REDUCE = "ctdd.train.reduce"
TRAIN_LOSS_READ = "ctdd.train.loss_read"
TRAIN_UPDATE = "ctdd.train.update"
SAMPLE_STEP = "ctdd.sample.step"
SAMPLE_TABLES = "ctdd.sample.tables"
SAMPLE_DENOISE = "ctdd.sample.denoise"
DATA_POOL_WAIT = "ctdd.data.pool_wait"

SPANS = (NETWORK, TRAIN_DRAW, TRAIN_LOSS, TRAIN_BACKWARD, TRAIN_REDUCE, TRAIN_LOSS_READ,
         TRAIN_UPDATE, SAMPLE_STEP, SAMPLE_TABLES, SAMPLE_DENOISE, DATA_POOL_WAIT)

NOOP = contextlib.nullcontext()

_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A `record_function(name)` range while a profiler records, else the
    shared no-op."""
    if _recording():
        return torch.profiler.record_function(name)
    return NOOP
