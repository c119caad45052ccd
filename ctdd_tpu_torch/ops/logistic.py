"""Truncated discretized-logistic output head.

Counterpart of ctdd_tpu/ops/logistic.py: maps network (mu, log s)
predictions to S-bin logits by integrating a logistic density over equal
bins on [-1, 1], with the PixelCNN++-style min-trick stabilizer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ctdd_tpu_torch.utils.math import log_minus_exp


def logistic_bin_logits(mu: torch.Tensor, log_scale: torch.Tensor, S: int,
                        fix_logistic: bool) -> torch.Tensor:
    """Discretized-logistic logits over S bins: mu/log_scale (...,) ->
    (..., S). The mean already carries the caller's tanh(x + mu') bias."""
    mu = mu[..., None]
    log_scale = log_scale[..., None]
    inv_scale = torch.exp(-(log_scale - 2.0))
    bin_width = 2.0 / S
    bin_centers = torch.linspace(-1.0 + bin_width / 2.0, 1.0 - bin_width / 2.0, S,
                                 dtype=mu.dtype, device=mu.device)
    sig_in_left = (bin_centers - bin_width / 2.0 - mu) * inv_scale
    bin_left_logcdf = F.logsigmoid(sig_in_left)
    sig_in_right = (bin_centers + bin_width / 2.0 - mu) * inv_scale
    bin_right_logcdf = F.logsigmoid(sig_in_right)

    logits_1 = log_minus_exp(bin_right_logcdf, bin_left_logcdf)
    if not fix_logistic:
        return logits_1
    logits_2 = log_minus_exp(-sig_in_left + bin_left_logcdf,
                             -sig_in_right + bin_right_logcdf)
    return torch.minimum(logits_1, logits_2)
