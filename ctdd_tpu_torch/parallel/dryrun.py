"""A data-parallel dry run over N processes on the tiny flagship geometry.

Counterpart of `__graft_entry__.dryrun_multichip` and
`scripts/multihost_dryrun.py`: N processes join one group, each on a card
(the default) or, with `--device cpu`, on the CPU. The backend is NCCL when
every process has a card of its own, and gloo on the CPU or where processes
share a card, which NCCL refuses; `--backend` overrides it. They take one
DP CTElbo step with EMA 0.9999 over their shards of a global batch
of 2 rows a rank, check a finite loss, `state.step == 1` and parameters
bit-identical on every rank, then save a checkpoint from rank 0 and restore
it on every rank.

    python -m ctdd_tpu_torch.parallel.dryrun --nprocs 2 [--device cpu|cuda]
        [--backend gloo|nccl]

prints `dryrun_multichip(N) ok: loss=...` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import tempfile
from typing import Optional

import numpy as np
import torch

from ctdd_tpu_torch.utils.device import resolve_device


def flagship_cfg(tiny: bool = False):
    """The flagship preset (tauUnet_mnist); `tiny`: 8x8 images, S=8, ch=8,
    one res block, ch_mult [1, 2], 2 heads, attention at 4 (the port's copy
    of `__graft_entry__._flagship_cfg`)."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset("tauUnet_mnist")
    if tiny:
        cfg.data.image_size = 8
        cfg.data.shape = [1, 8, 8]
        cfg.data.S = 8
        cfg.model.concat_dim = 64
        cfg.model.ch = 8
        cfg.model.num_res_blocks = 1
        cfg.model.ch_mult = [1, 2]
        cfg.model.num_heads = 2
        cfg.model.attn_resolutions = [4]
    return cfg


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs: int, *args):
    """Run `fn(rank, nprocs, port, *args)` in `nprocs` fresh processes (the
    spawn start method) and wait for all; raises if any of them failed. `fn`
    must be importable by name; `port` is a free localhost port for the
    group's rendezvous."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(nprocs, free_port()) + args, nprocs=nprocs,
                       start_method="spawn", join=True)


def join_group(rank: int, world: int, port: int, device: str, backend: str = "gloo"):
    """This process as rank `rank` of a `backend` group at localhost:`port`,
    one torch thread; returns its mesh."""
    from ctdd_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", world, rank, device=device, backend=backend)
    return make_mesh(world, device=device)


def _worker(rank: int, world: int, port: int, device: str, backend: str, ckpt_dir: str):
    import torch.distributed as dist

    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.parallel.dp import make_dp_train_step
    from ctdd_tpu_torch.parallel.mesh import shard_batch
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.utils.bookkeeping import CheckpointManager

    mesh = join_group(rank, world, port, device, backend)
    try:
        cfg = flagship_cfg(tiny=True)
        model = create_model(cfg, device=mesh.device)
        model.net.init_weights(torch.Generator().manual_seed(0))
        tx = get_optimizer(cfg)
        state = create_train_state(dict(model.net.named_parameters()), tx)
        step = make_dp_train_step(model, get_loss(cfg), tx, mesh, ema_decay=0.9999)
        batch = (np.random.RandomState(0)
                 .randint(0, cfg.data.S, size=(2 * world, cfg.model.concat_dim))
                 .astype(np.int32))
        state, loss = step(state, shard_batch(batch, mesh), 1)
        if not math.isfinite(loss):
            raise AssertionError(f"dry-run loss not finite: {loss}")
        if state.step != 1:
            raise AssertionError(f"state.step {state.step}, not 1")
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
        every = mesh.all_gather(flat[None])
        if not all(torch.equal(every[r], every[0]) for r in range(world)):
            raise AssertionError("parameters differ across ranks after the DP step")

        if rank == 0:
            CheckpointManager(ckpt_dir, cfg).save(state.step, state)
        dist.barrier()
        fresh = create_train_state({k: torch.zeros_like(v) for k, v in state.params.items()},
                                   tx)
        fresh = CheckpointManager(ckpt_dir).restore(fresh)
        if fresh.step != 1 or not all(torch.equal(fresh.params[k], state.params[k])
                                      for k in state.params):
            raise AssertionError(f"rank {rank}: the restored checkpoint differs")
        if rank == 0:
            print(f"dryrun_multichip({world}) ok: loss={loss:.4f} ({backend}, "
                  f"{mesh.device.type})", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_procs: int, device=None, backend: Optional[str] = None) -> None:
    """One DP train step over `n_procs` processes on `device` (the GPU
    unless the caller asks for the CPU), a rank-0 checkpoint saved and
    restored on every rank; raises on any failure. `backend` None: NCCL
    where each process has a card of its own, else gloo."""
    dev = resolve_device(device)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and n_procs <= torch.cuda.device_count()
                   else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_worker, n_procs, dev.type, backend, os.path.join(tmp, "checkpoints"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl where each process has a card, else gloo")
    args = ap.parse_args(argv)
    if args.backend == "nccl" and args.device == "cpu":
        ap.error("--backend nccl needs --device cuda")
    dryrun_multichip(args.nprocs, args.device, args.backend)


if __name__ == "__main__":
    main()
