"""Residual MLP score network.

Counterpart of ctdd_tpu/networks/mlp.py: normalize states ->
Linear(D -> d_model) -> num_layers x [residual FF + LayerNorm + FiLM(temb)]
-> Linear(d_model -> D*S) -> + one_hot(x) residual bias. Submodules are named
after the flax module's, in its creation order (see convert.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import TimeEmbedMLP, flax_init_, normalize_states


class ResidualMLP(nn.Module):
    def __init__(self, D: int, S: int, num_layers: int, d_model: int,
                 hidden_dim: int, time_scale_factor: float, temb_dim: int):
        super().__init__()
        self.D, self.S, self.d_model = D, S, d_model
        self.temb = TimeEmbedMLP(temb_dim, hidden_dim, 4 * temb_dim,
                                 time_scale_factor)
        self.dense_in = nn.Linear(D, d_model)
        self.ff_in = nn.ModuleList(
            nn.Linear(d_model, hidden_dim) for _ in range(num_layers))
        self.ff_out = nn.ModuleList(
            nn.Linear(hidden_dim, d_model) for _ in range(num_layers))
        # flax's LayerNorm epsilon
        self.norms = nn.ModuleList(
            nn.LayerNorm(d_model, eps=1e-6) for _ in range(num_layers))
        self.films = nn.ModuleList(
            nn.Linear(4 * temb_dim, 2 * d_model) for _ in range(num_layers))
        self.dense_out = nn.Linear(d_model, D * S)

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers (flax's defaults): every Dense
        kernel `lecun_normal`, biases 0, LayerNorm scale 1 and bias 0."""
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B, D = x.shape
        temb = self.temb(t)
        one_hot_x = F.one_hot(x.long(), self.S).float()
        h = self.dense_in(normalize_states(x, self.S))
        for ff_in, ff_out, norm, film in zip(self.ff_in, self.ff_out,
                                             self.norms, self.films):
            h = norm(h + ff_out(F.relu(ff_in(h))))
            film_params = film(temb)
            h = film_params[:, : self.d_model] * h + film_params[:, self.d_model:]
        return self.dense_out(h).reshape(B, D, self.S) + one_hot_x

