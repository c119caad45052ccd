"""Data parallelism over torch.distributed: the process group's mesh
(`mesh.py`), the mean-reduced train steps and the sharded sampler (`dp.py`),
and a multi-process dry run (`dryrun.py`)."""

from ctdd_tpu_torch.parallel.dp import (  # noqa: F401
    make_device_data_train_step,
    make_dp_sampler,
    make_dp_train_step,
)
from ctdd_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
