"""Models: network x forward process; importing registers the zoo."""

from ctdd_tpu_torch.models import zoo  # noqa: F401
