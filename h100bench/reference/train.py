"""The train step in plain PyTorch, shared by every reference family: the
benchmark's reference.

One step of one rank: the batch rows drawn from the step's generator,
dropout from the device's default generator, then the family's
`per_row_loss` (tau_unet's: the times, x_t ~ q_{t|0}(.|x0) and the
one-jump x~ from the same generator, the CT-ELBO) and the gradients. Over
the ranks the losses and the gradients are averaged, then clipped by their
global norm, Adam (optax's defaults) takes the step and the EMA follows
with its warm-up ramp.

The draws follow the program's stated scheme, so the reference sees the
rows, times, states and dropout masks the program saw: the step's two
seeds are NumPy's `SeedSequence([seed, step] (+ [rank] above rank 0))`,
the first seeding the step's generator, the second the device's default
generator, and the draws come in the order the algorithm needs them
(the rows first, then the family's loss's own).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

NEG = -1e9
B1, B2, EPS = 0.9, 0.999, 1e-8


def step_seeds(seed: int, step: int, rank: int = 0):
    entropy = [seed, step] + ([rank] if rank else [])
    return tuple(int(s) for s in np.random.SeedSequence(entropy).generate_state(2))


def seed_dropout(device: torch.device, s: int) -> None:
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(s)
    else:
        torch.default_generator.manual_seed(s)


def safe_log(p):
    bad = p <= 0.0
    return torch.where(bad, torch.full_like(p, NEG), torch.log(torch.where(bad, 1.0, p)))


def categorical(gen, logits):
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + g, dim=-1)


def rows(mat, idx):
    """out[b, d, :] = mat[b, idx[b, d], :]"""
    return torch.gather(mat, 1, idx.long()[:, :, None].expand(-1, -1, mat.shape[-1]))


def rank_loss_grads(per_row_loss, net, proc, cfg, data, seed: int, step: int, rank: int,
                    per_rank: int, keep: Optional[int] = None):
    """One rank's (loss, grads, logits) at `step`, the terms from the
    family's `per_row_loss`. `keep` < per_rank averages the loss over the
    first `keep` rows only (a planted fault)."""
    s_draw, s_drop = step_seeds(seed, step, rank)
    seed_dropout(data.device, s_drop)
    gen = torch.Generator(device=data.device).manual_seed(s_draw)
    idx = torch.randint(0, data.shape[0], (per_rank,), generator=gen, device=data.device)
    terms, logits = per_row_loss(net, proc, cfg, data[idx], gen, step)
    loss = terms[:keep].mean() if keep else terms.mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return loss.detach(), grads, logits.detach()


class Reference:
    """The reference's train state over `net`'s parameters: Adam's
    moments, the EMA and the counters, all float32; the loss is the
    family's `per_row_loss`."""

    def __init__(self, per_row_loss, net, proc, cfg: dict):
        self.per_row_loss = per_row_loss
        self.net, self.proc, self.cfg = net, proc, cfg
        self.params = list(net.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.count = 0
        self.ema_n = 0

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        tc = self.cfg["training"]
        if not tc.get("clip_grad", False):
            return grads
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if norm < tc["grad_norm"]:
            return grads
        return [g / norm * tc["grad_norm"] for g in grads]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        lr = float(np.float32(self.cfg["optimizer"]["lr"]))
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            p.add_(-lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
        self.ema_n += 1
        decay = float(self.cfg["model"]["ema_decay"])
        d = float(np.minimum(np.float32(decay),
                             np.float32(1.0 + self.ema_n) / np.float32(10.0 + self.ema_n)))
        for e, p in zip(self.ema, self.params):
            e.sub_((1.0 - d) * (e - p))

    def step(self, data, seed: int, step: int, ranks: int, per_rank: int,
             keep_ranks: Optional[int] = None, keep_rows: Optional[int] = None):
        """One global step: every rank's loss and gradients (the first
        `keep_ranks` ranks only, where given: a planted fault), their mean,
        the clip and the update. Returns (loss, the clipped gradients, rank
        0's logits)."""
        self.net.train()
        losses, total, first = [], None, None
        used = keep_ranks or ranks
        for r in range(used):
            loss, grads, logits = rank_loss_grads(self.per_row_loss, self.net, self.proc,
                                                  self.cfg, data, seed, step, r, per_rank,
                                                  keep_rows)
            first = logits if first is None else first
            losses.append(loss)
            total = list(grads) if total is None else [a + b for a, b in zip(total, grads)]
        grads = self.clip([g / used for g in total])
        self.update(grads)
        return float(torch.stack(losses).mean()), grads, first


def worst_leaf_gap(prog: torch.Tensor, ref: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref)."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    scale = torch.clamp(ref, min=float(ref.median()))
    return float(((prog - ref).abs() / scale).max())

