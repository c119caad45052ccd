"""The data-parallel process group: who this rank is and where it runs.

Counterpart of ctdd_tpu/parallel/mesh.py. JAX's mesh is a 1-D array of
devices inside one program; here each rank is one process on one device, in
a `torch.distributed` process group, and `Mesh` describes that group from
this rank's side: world size, rank, this rank's device and the backend
(NCCL for CUDA devices, gloo for the CPU, or for several ranks that share
one card, which NCCL refuses). Parameters, optimizer state and a dataset on
the device are each rank's own full copies, kept equal by the mean-reduced
update of parallel/dp.py; a batch is split by `shard_batch`. So JAX's
`batch_sharding` and `replicated` (NamedShardings of a global array) have no
counterpart here. Under gloo, CUDA tensors pass through the host for each
collective.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ctdd_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"  # the one axis: the ranks


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the group; `backend` None is the one-rank mesh
    without a process group, where every collective is the identity."""

    world: int
    rank: int
    device: torch.device
    backend: Optional[str] = None

    def _staged(self, tensor: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: gloo reduces on the host."""
        return tensor.cpu() if self.backend == "gloo" and tensor.is_cuda else tensor

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """`flat` in place: the sum over the ranks, divided by the world
        size (JAX's `pmean`)."""
        if self.backend is None:
            return flat
        buf = self._staged(flat)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        buf.div_(self.world)
        if buf is not flat:
            flat.copy_(buf)
        return flat

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-shaped `tensor`, concatenated along axis 0 in
        rank order (JAX's `out_specs=P(axis)`)."""
        if self.backend is None:
            return tensor
        buf = self._staged(tensor.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(tensor.device)

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (every rank gets the answer)."""
        if self.backend is None:
            return bool(flag)
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def broadcast_object(self, obj):
        """Rank 0's `obj` (picklable), on every rank."""
        if self.backend is None:
            return obj
        box = [obj if self.rank == 0 else None]
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        dist.broadcast_object_list(box, src=0, device=dev)
        return box[0]


def _rank_device(device, rank: int, world: int) -> torch.device:
    """`device`, with a CUDA device without an index pinned to this rank's
    card (LOCAL_RANK under torchrun, else the rank, modulo the cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and world > 1:
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current card
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialized process group, or the one-rank mesh
    without one, on `device` (the GPU unless the caller asks for the CPU).
    Raises if `n_devices` is not the group's world size."""
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of that "
                         f"size; this one has {world}")
    return Mesh(world=world, rank=rank, device=_rank_device(device, rank, world),
                backend=backend)


def shard_batch(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch, [r·B/W, (r+1)·B/W), on its device:
    the shard JAX's `P(DATA_AXIS)` layout gives device r. Every rank passes
    the same global batch."""
    batch = torch.as_tensor(np.asarray(batch))
    if batch.shape[0] % mesh.world:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split over "
                         f"{mesh.world} ranks")
    n = batch.shape[0] // mesh.world
    return batch[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         device=None, backend: Optional[str] = None):
    """Join the process group: at `coordinator_address` ("host:port") as rank
    `process_id` of `num_processes`, or, without an address, from torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The backend is
    NCCL for a CUDA `device` (the default) and gloo for the CPU, unless
    `backend` names one (gloo lets several ranks share one card)."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
