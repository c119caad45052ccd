"""The reference family of the tauLDR UNets (`tauUnet_mnist`,
`tauUnet_cifar10`): the UNet (`unet.py`), the GaussianTargetRate process
(`process.py`), the CT-ELBO over its dense (B, S, S) tables (CTElbo, or its
annealed mix with the cross entropy, CTElboLambda), and the tiny widths of
the harness's CPU tests. The contract is in `reference/__init__.py`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from h100bench.reference.process import GaussianTargetRate
from h100bench.reference.train import categorical, rows, safe_log
from h100bench.reference.unet import Net

__all__ = ["Net", "process", "per_row_loss", "forward_flops", "shrink"]


def process(cfg: dict, device) -> GaussianTargetRate:
    return GaussianTargetRate(cfg["model"], cfg["data"]["S"], device)


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


def forward_flops(cfg: dict, batch: int) -> float:
    """FLOPs of one forward of the UNet at `batch`, counted by
    FlopCounterMode on the meta device (shapes only, nothing computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = Net(cfg)
    D = math.prod(cfg["data"]["shape"])
    x = torch.zeros((batch, D), dtype=torch.int32, device="meta")
    t = torch.zeros((batch,), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x, t)
    return float(counter.get_total_flops())


def shrink(cfg: dict) -> dict:
    """The configuration at tiny widths: 8x8 images, ch 8, 5 steps; S as published."""
    m, d = cfg["model"], cfg["data"]
    m.update(ch=8, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[4], num_heads=2,
             data_min_max=[0, 255], time_embed_dim=8)
    d.update(S=256, image_size=8, shape=[m["input_channels"], 8, 8], batch_size=4)
    m["concat_dim"] = m["input_channels"] * 64
    cfg["sampler"]["num_steps"] = 5
    cfg["about"]["dataset_rows"] = 32
    return cfg
