"""How often the dense products ran on the 3xTF32 kernel: the FLOPs its
launches did (the program's counter `ops/tf32x3_gemm.py::matmul.flops`,
2 M N K a launch) over three times the dense forward FLOPs the network
counted at its forwards' shapes (`networks/sdar_moe.py::DENSE_FLOPS`: each
forward product has an input gradient and a weight gradient of its size),
in this process, in percent. None where the program keeps no such counters
or its network counted no dense product."""

import sys

from h100bench import common


def read(ctx):
    if not common.is_train(ctx):
        return None
    counted = getattr(sys.modules.get("ctdd_tpu_torch.networks.sdar_moe"), "DENSE_FLOPS", None)
    matmul = getattr(sys.modules.get("ctdd_tpu_torch.ops.tf32x3_gemm"), "matmul", None)
    if not counted or not counted.get("forward") or matmul is None:
        return None
    return 100.0 * matmul.flops / (3.0 * counted["forward"])
