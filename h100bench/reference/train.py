"""The tauLDR train step in plain PyTorch: the benchmark's reference.

One step of one rank: the batch rows, the times, x_t ~ q_{t|0}(.|x0) and
the one-jump x~ drawn from the step's generator, dropout from the device's
default generator; the CT-ELBO (CTElbo) or its annealed mix with the cross
entropy (CTElboLambda); the gradients. Over the ranks the losses and the
gradients are averaged, then clipped by their global norm, Adam (optax's
defaults) takes the step and the EMA follows with its warm-up ramp.

The draws follow the program's stated scheme, so the reference sees the
rows, times, states and dropout masks the program saw: the step's two
seeds are NumPy's `SeedSequence([seed, step] (+ [rank] above rank 0))`,
the first seeding the step's generator, the second the device's default
generator, and the draws come in the order the algorithm needs them
(rows, times, x_t, the jump's dimension, its new state).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def per_row_loss(net, proc, cfg: dict, x0, gen, n_iter: int):
    """(B,) loss terms of one rank's batch, whose mean is the loss, and the
    network's (B, D, S) logits."""
    lc, S = cfg["loss"], cfg["data"]["S"]
    B, D = x0.shape
    eps = lc["eps_ratio"]
    min_t, max_t = lc["min_time"], cfg["training"]["max_t"]
    ts = torch.rand((B,), generator=gen, device=x0.device) * (max_t - min_t) + min_t
    qt0, rate = proc.transition(ts), proc.rate(ts)
    x_t = categorical(gen, safe_log(rows(qt0, x0)))
    iota = torch.arange(S, device=x0.device)
    rate_rows = torch.where(iota == x_t[..., None], 0.0, rows(rate, x_t))
    dims = categorical(gen, safe_log(rate_rows.sum(-1)))
    newval = categorical(gen, safe_log(rate_rows[torch.arange(B, device=x0.device), dims]))
    x_tilde = torch.where(torch.arange(D, device=x0.device)[None] == dims[:, None],
                          newval[:, None], x_t)
    logits = net(x_t, ts)
    p0t = torch.softmax(logits, dim=-1)
    qT = qt0.transpose(1, 2)  # rows of qT are columns of qt0
    off = (iota != x_tilde[..., None]).float()
    denom = rows(qT, x_tilde) + eps  # q_{t|0}(x~ | .)
    r_in = rows(rate.transpose(1, 2), x_tilde)  # R(., x~)
    reg = torch.einsum("bds,bks->bdk", off * r_in, qt0)
    reg = (p0t / denom * reg).sum((1, 2))
    inner = torch.log(torch.einsum("bds,bsk->bdk", p0t / denom, qt0) + eps)
    numer = rows(qt0, x0)  # q_{t|0}(. | x0)
    elem = torch.gather(numer, 2, x_tilde.long()[..., None])[..., 0] + eps
    sig = (off * r_in * numer / elem[..., None] * inner).sum((1, 2))
    out_rate = -torch.diagonal(rate, dim1=1, dim2=2)  # (B, S)
    z_dim = torch.gather(out_rate, 1, x_tilde.long())
    z = z_dim.sum(1)[:, None, None] - z_dim[..., None] + out_rate[:, None, :]
    norm = (r_in * numer * off / (z * elem[..., None])).sum((1, 2))
    elbo = reg - sig / norm
    if lc["name"] == "CTElbo":
        ce = -torch.gather(F.log_softmax(logits, -1), -1, x0.long()[..., None])[..., 0].mean(1)
        return elbo + lc["nll_weight"] * ce, logits
    if lc["name"] == "CTElboLambda":
        w = n_iter / cfg["training"]["n_iters"]
        ce = -torch.gather(F.log_softmax(logits, -1), -1, x0.long()[..., None])[..., 0].mean(1)
        return w * elbo + (1.0 - w) * ce, logits
    raise ValueError(f"no reference loss {lc['name']!r}")


def rank_loss_grads(net, proc, cfg, data, seed: int, step: int, rank: int,
                    per_rank: int, keep: Optional[int] = None):
    """One rank's (loss, grads, logits) at `step`. `keep` < per_rank
    averages the loss over the first `keep` rows only (a planted fault)."""
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
    moments, the EMA and the counters, all float32."""

    def __init__(self, net, proc, cfg: dict):
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
            loss, grads, logits = rank_loss_grads(self.net, self.proc, self.cfg, data, seed,
                                                  step, r, per_rank, keep_rows)
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

