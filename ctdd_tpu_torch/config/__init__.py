"""Config plumbing of the port."""

from ctdd_tpu_torch.config.base import Config  # noqa: F401
