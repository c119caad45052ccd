"""The share of the process's train-step loss reads that were taken when
the loss's forward ended (a copy behind the forward, so that the update is
launched while the backward is still queued) rather than after a reduce,
from the program's counter `training/train_step.py::LOSS_READS`, in
percent. None where the program keeps no such counter."""

import sys

from h100bench import common


def read(ctx):
    if not common.is_train(ctx):
        return None
    reads = getattr(sys.modules.get("ctdd_tpu_torch.training.train_step"), "LOSS_READS", None)
    if not reads:
        return None
    total = sum(reads.values())
    return 100.0 * reads.get("after_forward", 0) / total if total else None
