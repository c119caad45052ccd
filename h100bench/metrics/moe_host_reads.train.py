"""The host's reads of the expert layer's routing a train step: the
program's counter `networks/sdar_moe.py::MOE_HOST_READS`, its reads of the
held experts' counts over the network's forwards in the process (one
forward a step). None where the program keeps no such counter or ran no
such network."""

import sys

from h100bench import common


def read(ctx):
    if not common.is_train(ctx):
        return None
    counter = getattr(sys.modules.get("ctdd_tpu_torch.networks.sdar_moe"), "MOE_HOST_READS",
                      None)
    if not counter or not counter.get("forwards"):
        return None
    return counter["reads"] / counter["forwards"]
