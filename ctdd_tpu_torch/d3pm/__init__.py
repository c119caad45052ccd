"""The D3PM baseline (discrete-time categorical diffusion) of the port."""

from ctdd_tpu_torch.d3pm.diffusion import (  # noqa: F401
    CategoricalDiffusion, D3PMLoss, make_diffusion,
)
