"""Energy-based score functions: (x (B, D), t (B,)) -> energies (B,).

Counterpart of ctdd_tpu/networks/ebm.py. The EBM losses and samplers tile
single-site mutations around these nets (`losses.ebm_all_mutation_logits`,
`losses.bin_ebm_flip_logits`). Submodules carry flax's names, so
`convert.hollow_params_from_flax` maps the weights.

- `BinaryMLPScoreFunc`: per layer a Dense plus the time embedding, ELU; a
  scalar head.
- `CatMLPScoreFunc`: embedded states, flattened; per layer a Dense plus the
  time embedding, SiLU; a scalar head.
- `BinaryTransformerScoreFunc`: a CLS token (state S) prepended, the masked
  transformer's readout at position 0, channel 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctdd_tpu_torch.networks.common import numbered_children
from ctdd_tpu_torch.networks.hollow import MaskedTransformer, _FlaxInit
from ctdd_tpu_torch.ops.timestep import timestep_embedding


class _MLPScoreFunc(_FlaxInit):
    def __init__(self, cfg, in_dim: int, act):
        super().__init__()
        m = cfg.model
        self.hidden, self.scale, self.n, self.act = (
            m.mlp_dim, m.time_scale_factor, m.num_layers, act)
        dims = [in_dim] + [m.mlp_dim] * m.num_layers
        for i in range(m.num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], m.mlp_dim))
        self.add_module(f"Dense_{m.num_layers}", nn.Linear(m.mlp_dim, 1))

    def _energy(self, h, t):
        temb = timestep_embedding(t * self.scale, self.hidden)
        for dense in numbered_children(self, "Dense", self.n):
            h = self.act(dense(h) + temb)
        return getattr(self, f"Dense_{self.n}")(h)[..., 0]


class BinaryMLPScoreFunc(_MLPScoreFunc):
    def __init__(self, cfg):
        super().__init__(cfg, cfg.model.concat_dim, F.elu)

    def forward(self, x, t):
        return self._energy(x.to(self.Dense_0.weight.dtype), t)


class CatMLPScoreFunc(_MLPScoreFunc):
    def __init__(self, cfg):
        super().__init__(cfg, cfg.model.concat_dim * cfg.model.embed_dim, F.silu)
        self.Embed_0 = nn.Embedding(cfg.data.S, cfg.model.embed_dim)

    def forward(self, x, t):
        h = self.Embed_0(x.long())
        return self._energy(h.reshape(h.shape[0], -1), t)


class BinaryTransformerScoreFunc(_FlaxInit):
    def __init__(self, cfg):
        super().__init__()
        self.m, self.S = cfg.model, cfg.data.S
        self.MaskedTransformer_0 = MaskedTransformer(cfg)

    def forward(self, x, t):
        temb = timestep_embedding(t * self.m.time_scale_factor, self.m.embed_dim)
        B = x.shape[0]
        cls = torch.full((B, 1), self.S, dtype=x.dtype, device=x.device)
        full = self.MaskedTransformer_0(torch.cat([cls, x.reshape(B, -1)], dim=1), temb)
        return full[:, 0, 0]
