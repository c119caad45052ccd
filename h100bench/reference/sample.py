"""Checks of a tau-leaping sampler run against the plain reference.

The reference follows the program's own trajectory: given the states x_k
that the program's network saw at each step (and x_T, the first of them),
it recomputes in float32 what the step should do.

- `denoise_gap`: the samples are the argmax of p_{0|min_t} at the last
  state, a greedy choice; the reference's logits there give, for every
  position, how far the program's token lies below the reference's best.
- The jumps, step by step: a tau-leap step draws N_y ~ Poisson(h R^(x -> y))
  jumps to every state y of every dimension and moves x by the ordinal sum
  U = sum_y N_y (y - x), clamped to [0, S-1]. With L = h sum_y R^(x -> y),
  a dimension changes with a probability between L e^-L (exactly one
  jump) and 1 - e^-L (any jump): `steps_outside_law` counts the steps whose
  number of changed dimensions lies more than 6 standard deviations
  outside the sums of those bounds.
- Where the tokens go, on every step whose jump intensities h R^ are all at
  most LAM_EXACT (the later ones: early in the schedule the rates are so
  high that the sampler's cap of MAX_JUMPS on each N_y gives U another
  law). U is compound Poisson, so its law is exact
  through its characteristic function exp(sum_y h R^(x -> y)
  (e^{i w (y - x)} - 1)), one FFT a dimension; from it come E[Delta],
  E|Delta| and E[Delta^2] of the clamped change Delta of every dimension.
  The cap moves Delta by at most c = sum_y E[(N_y - MAX_JUMPS)^+] |y - x| in
  expectation, an allowance that is added. `jump_drift_sd` holds
  sum_d E[Delta_d] Delta_d (the change along each dimension's expected
  direction) against sum_d E[Delta_d]^2, `jump_size_sd` holds
  sum_d |Delta_d| against sum_d E|Delta_d|; each is the widest gap beyond
  the allowance over those steps, in standard deviations of that sum.
  Jumps the wrong way, to the wrong states or to uniform ones, or none,
  move one or both far more than a sound step can.
- `prior_states_outside_law`: x_T is drawn from the discretized Gaussian
  prior; a state counts when its count lies more than 6 standard
  deviations from its expectation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIGMAS = 6.0
FAR = 1e30  # a law broken where it allows no spread at all
FOLD = 1e-12  # the mass of a jump sum the circle may fold over
MAX_FOLDS = 64  # the largest circle, in multiples of S
MAX_JUMPS = 12  # the sampler's cap on each Poisson count
LAM_EXACT = 2.0  # the largest intensity of a step whose laws of destination are taken


def time_grid(max_t: float, min_t: float, num_steps: int):
    ts = np.concatenate((np.linspace(max_t, min_t, num_steps), [0.0]))
    return ts[:-1].astype(np.float32), (ts[:-1] - ts[1:]).astype(np.float32)


def logits(net, x, t: float, block: int):
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block]
        yield i, net(xb, torch.full((xb.shape[0],), t, device=x.device))


@torch.no_grad()
def denoise_gap(net, x_last, tokens, min_t: float, block: int) -> float:
    gap = 0.0
    for i, lg in logits(net, x_last, min_t, block):
        chosen = torch.gather(lg, -1, tokens[i:i + lg.shape[0]].long()[..., None])[..., 0]
        gap = max(gap, float((lg.max(-1).values - chosen).max()))
    return gap


@torch.no_grad()
def clamped_moments(lam, x, S: int):
    """E[Delta], E|Delta|, E[Delta^2] of Delta = clamp(x + U, 0, S-1) - x,
    U = sum_y N_y (y - x), N_y ~ Poisson(lam[..., y]) independent; float64.

    The law of U is taken on a circle of M points, which folds the mass
    beyond M/2 over; M doubles until the law holds less than FOLD between
    M/4 and M/2, so that what it folds is below that."""
    lam, x = lam.reshape(-1, S).double(), x.reshape(-1).long()
    iota = torch.arange(S, device=x.device)
    M = 4 * S
    while True:
        jumps = torch.zeros(lam.shape[0], M, dtype=torch.float64, device=x.device)
        jumps.scatter_(1, (iota - x[:, None]) % M, lam)
        law = torch.fft.irfft(torch.exp(torch.fft.rfft(jumps) - lam.sum(-1, keepdim=True)),
                              n=M)
        u = torch.arange(M, device=x.device)
        u = torch.where(u < M // 2, u, u - M)
        far = float(law[:, u.abs() >= M // 4].sum(-1).max())
        if far < FOLD or M >= MAX_FOLDS * S:
            break
        M *= 2
    delta = ((x[:, None] + u).clamp(0, S - 1) - x[:, None]).double()
    return ((law * delta).sum(-1), (law * delta.abs()).sum(-1),
            (law * delta * delta).sum(-1))


def cap_excess(lam):
    """E[(N - MAX_JUMPS)^+] of N ~ Poisson(lam), elementwise; float64."""
    lam = lam.double()
    return (lam * torch.special.gammainc(torch.full_like(lam, MAX_JUMPS), lam)
            - MAX_JUMPS * torch.special.gammainc(torch.full_like(lam, MAX_JUMPS + 1), lam))


@torch.no_grad()
def step_sums(net, proc, x, x_next, t: float, h: float, eps: float, block: int) -> dict:
    """The sums over the dimensions of one step from x to x_next at (t, h)
    that the laws of the jumps compare; `held` is false where an intensity
    exceeds LAM_EXACT and the laws of where the tokens go are not taken."""
    tt = torch.full((1,), float(t), device=x.device)
    qt0, rate = proc.transition(tt)[0], proc.rate(tt)[0]
    S = qt0.shape[0]
    iota = torch.arange(S, device=x.device)
    sums = dict.fromkeys(("lo", "hi", "changed", "drift", "drift_mean", "drift_var",
                          "drift_slack", "size", "size_mean", "size_var", "size_slack"), 0.0)
    sums["held"] = True
    for i, lg in logits(net, x, t, block):
        xb = x[i:i + lg.shape[0]].long()
        step = (x_next[i:i + lg.shape[0]].long() - xb).reshape(-1).double()
        p = torch.softmax(lg, -1)
        ratio = (p / (qt0.t()[xb] + eps)).reshape(-1, S) @ qt0
        rev = rate.t()[xb] * ratio.reshape(p.shape)
        lam = h * torch.where(iota == xb[..., None], 0.0, rev)
        L = lam.sum(-1).reshape(-1).double()
        for key, value in (("lo", L * torch.exp(-L)), ("hi", -torch.expm1(-L)),
                           ("changed", step != 0), ("size", step.abs())):
            sums[key] += float(value.sum())
        sums["held"] = sums["held"] and float(lam.max()) <= LAM_EXACT
        if not sums["held"]:
            continue
        mean, mean_abs, mean_sq = clamped_moments(lam, xb, S)
        cut = (cap_excess(lam) * (iota - xb[..., None]).abs()).sum(-1).reshape(-1)
        for key, value in (
                ("drift", mean * step), ("drift_mean", mean * mean),
                ("drift_var", mean * mean * (mean_sq - mean * mean)),
                ("drift_slack", mean.abs() * cut), ("size_mean", mean_abs),
                ("size_var", mean_sq - mean_abs * mean_abs), ("size_slack", cut)):
            sums[key] += float(value.sum())
    return sums


def gap_sd(value: float, mean: float, slack: float, var: float) -> float:
    """How far `value` lies from `mean` beyond `slack`, in standard deviations."""
    gap = max(0.0, abs(value - mean) - slack)
    if gap == 0.0:
        return 0.0
    return gap / math.sqrt(var) if var > 0.0 else FAR


def jump_laws(net, proc, traj, cfg: dict, block: int) -> dict:
    """traj: the states of steps 0..K (x_T first, the denoise's input last).
    Returns `steps_outside_law`, `jump_drift_sd`, `jump_size_sd` and
    `held_steps`, the number of steps the last two were taken on."""
    sc = cfg["sampler"]
    if not sc.get("is_ordinal", True):
        raise ValueError("the laws of the jumps know the ordinal tau-leap update")
    ts, hs = time_grid(cfg["training"].get("max_t", 1.0), sc["min_t"], sc["num_steps"])
    outside, drift_sd, size_sd, held = 0, 0.0, 0.0, 0
    for k in range(len(ts)):
        s = step_sums(net, proc, traj[k], traj[k + 1], float(ts[k]), float(hs[k]),
                      sc["eps_ratio"], block)
        slack = SIGMAS * math.sqrt(max(s["hi"], 1.0))
        outside += not (s["lo"] - slack <= s["changed"] <= s["hi"] + slack)
        if s["held"]:
            held += 1
            drift_sd = max(drift_sd, gap_sd(s["drift"], s["drift_mean"], s["drift_slack"],
                                            s["drift_var"]))
            size_sd = max(size_sd, gap_sd(s["size"], s["size_mean"], s["size_slack"],
                                          s["size_var"]))
    return {"steps_outside_law": outside, "jump_drift_sd": drift_sd, "jump_size_sd": size_sd,
            "held_steps": held}


def prior_states_outside_law(x_T, cfg: dict) -> int:
    S, sigma = cfg["data"]["S"], float(cfg["model"]["Q_sigma"])
    if cfg["sampler"]["initial_dist"] != "gaussian":
        raise ValueError("the prior check knows the gaussian initial distribution")
    target = np.exp(-((np.arange(1, S + 1) - S // 2) ** 2) / (2 * sigma ** 2))
    p = target / target.sum()
    n = x_T.numel()
    counts = torch.bincount(x_T.reshape(-1).long(), minlength=S).cpu().numpy()
    if counts.shape[0] > S:
        return S
    dev = np.abs(counts - n * p) / np.sqrt(n * p * (1 - p))
    return int((dev > SIGMAS).sum())
