"""The GaussianTargetRate forward process in plain PyTorch and NumPy.

The tauLDR paper's banded Gaussian rate matrix with detailed-balance
transposes, its schedule beta(t) = b * ln(e) * e^t, and the transition
q_{t|0} = V exp(Lambda * integral of beta) V^-1, each row renormalized and
entries under 1e-8 set to 0. The eigendecomposition is NumPy's, in
float64, rounded to float32; the tables are made from it in float32 (with
TF32 off), as the published method makes them. The ELBO divides by table
entries near the 1e-8 clamp, so its gradient follows those entries' float32
rounding closely: tables made in float64 would be another computation.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def base_rate(S: int, rate_sigma: float, Q_sigma: float) -> np.ndarray:
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    vals = np.exp(-np.arange(S) ** 2 / rate_sigma ** 2)
    upper = (i < S // 2) & (j > i) & (j < S - i)
    lower = (i > S // 2) & (j < i) & (j > S - i - 1)
    band = np.where(j > i, j - i - 1, i - j - 1)
    rate = np.where(upper | lower, vals[np.clip(band, 0, S - 1)], 0.0)
    balanced = rate.T * np.exp(
        -((j + 1.0) ** 2 - (i + 1.0) ** 2 + S * (i + 1.0) - S * (j + 1.0))
        / (2.0 * Q_sigma ** 2))
    rate = np.where(rate.T > 0.0, balanced, rate)
    rate -= np.diag(np.diag(rate))
    return rate - np.diag(rate.sum(axis=1))


class GaussianTargetRate:
    def __init__(self, model_cfg: dict, S: int, device):
        R = base_rate(S, model_cfg["rate_sigma"], model_cfg["Q_sigma"])
        w, V = np.linalg.eig(R)
        self.time_base = float(model_cfg["time_base"])
        self.time_exp = float(model_cfg["time_exp"])
        f32 = lambda a: torch.as_tensor(np.real(a), dtype=torch.float32, device=device)  # noqa: E731
        self.R = f32(R)
        self.eigvals, self.V, self.Vinv = f32(w), f32(V), f32(np.linalg.inv(V))

    def rate(self, t: torch.Tensor) -> torch.Tensor:
        """R_t = beta(t) R, (B, S, S)."""
        beta = self.time_base * math.log(self.time_exp) * torch.pow(self.time_exp, t)
        return self.R[None] * beta[:, None, None]

    def transition(self, t: torch.Tensor) -> torch.Tensor:
        """q_{t|0}, (B, S, S)."""
        integral = (self.time_base * torch.pow(self.time_exp, t) - self.time_base) - (
            self.time_base * torch.pow(self.time_exp, torch.zeros_like(t)) - self.time_base)
        q = torch.matmul(self.V[None] * torch.exp(integral[:, None] * self.eigvals[None, :])
                         [:, None, :], self.Vinv)
        q = q / q.sum(-1, keepdim=True)
        return torch.where(q < 1e-8, torch.zeros_like(q), q)
