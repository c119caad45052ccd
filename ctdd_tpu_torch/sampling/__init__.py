"""Reverse-CTMC samplers of the port."""

from ctdd_tpu_torch.sampling.samplers import TauL, get_sampler  # noqa: F401
