"""Training losses of the port; importing registers them."""

from ctdd_tpu_torch.losses.losses import CTElbo, NLLOriginal, get_loss  # noqa: F401
