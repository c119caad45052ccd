"""Reverse-CTMC samplers on the p0t path: TauL, LBJF, MidPointTauL.

Counterpart of those samplers in ctdd_tpu/sampling/samplers.py, correctors
included. The JAX package scans a compiled step over a precomputed time
grid; here the same step runs in an eager Python loop over the same float32
grid.

- TauL: with `sampler.use_fused_update` every step's update is one launch of
  the fused tau-leap kernel (ops/fused_update.py); otherwise reverse rates
  (ops/rate_kernels.py) and Poisson jumps.
- LBJF: reverse rates, then the Euler posterior (both ops/rate_kernels.py)
  and a Gumbel-max categorical draw.
- MidPointTauL: fused, two launches of the fused kernel per step ("expected"
  over h/2, then "poisson" from the midpoint state); unfused, two
  reverse-rate passes.

Randomness comes from an explicit `torch.Generator` on the model's device:
it draws x_T, the uniforms and Gumbel noise of the unfused updates and, once
per batch, the base word of the fused kernel's Philox key (the second word
is the step index).
"""

from __future__ import annotations

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing, rate_kernels
from ctdd_tpu_torch.ops.fused_update import fused_tau_leap_update
from ctdd_tpu_torch.utils.device import resolve_device

TAULDR_LOSSES = ("CTElbo", "NLL", "CTElboLambda", "NLLOriginal")


def rate_param_from_loss(loss_name: str) -> str:
    """'p0t' (tauLDR x0-parameterization) or 'ratio' (CRM log-prob ratios)."""
    return "p0t" if loss_name in TAULDR_LOSSES else "ratio"


def get_sampler(cfg):
    return registry.samplers.get(cfg.sampler.name)(cfg)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def get_initial_samples(
    generator, N: int, D: int, S: int, initial_dist: str,
    initial_dist_std: float = None, device=None,
) -> torch.Tensor:
    """Uniform or discretized-Gaussian prior x_T, (N, D) int32."""
    device = resolve_device(device)
    if initial_dist == "uniform":
        return torch.randint(0, S, (N, D), generator=generator, device=device,
                             dtype=torch.int32)
    if initial_dist == "gaussian":
        target = np.exp(
            -((np.arange(1, S + 1) - S // 2) ** 2) / (2 * float(initial_dist_std) ** 2)
        )
        probs = torch.as_tensor(target / target.sum(), dtype=torch.float32,
                                device=device)
        draws = torch.multinomial(probs, N * D, replacement=True, generator=generator)
        return draws.reshape(N, D).to(torch.int32)
    raise ValueError(f"unrecognized initial dist {initial_dist}")


def reverse_rates(
    model, params, logits, x, t, *, rate_param: str, logit_type: str, eps: float,
):
    """R̂_t(x -> ·) per dim with a timestep per sample, t (N,):
    (rates, ratio), both (N, D, S). The rates come from the reverse-rates
    kernel, so their entry at x is 0; the ratio is not masked."""
    if rate_param != "p0t":
        raise NotImplementedError(
            f"rate_param={rate_param!r}: the CRM ratio path is ported with "
            "the CRM losses in a later slice"
        )
    qt0 = model.transition(t)  # (N, S, S)
    rate = model.rate(t)
    qt0_denom = indexing.cols(qt0, x) + eps  # q_{t|0}(x | x0) over x0
    forward_rates = indexing.cols(rate, x)  # R(·, x) over target states
    rates = rate_kernels.reverse_rates(logits, qt0_denom, qt0, forward_rates, x)
    # the kernel keeps the ratio to itself; callers that want it (the
    # losses) get the plain product
    ratio = torch.einsum(
        "bds,bsk->bdk", torch.softmax(logits, dim=-1) / qt0_denom, qt0
    )
    return rates, ratio


def _shared_mats(process, t: float):
    """(S, S) transition and rate at one shared timestep."""
    # a device-side fill: a host-to-device copy would wait for the device
    t1 = torch.full((1,), t, dtype=torch.float32, device=process.device)
    return process.transition(t1)[0], process.rate(t1)[0]


def reverse_rates_shared(
    process, logits, x, t: float, *, rate_param: str, logit_type: str,
    eps: float,
):
    """Shared-timestep reverse rates R̂_t(x -> ·) per dim, (N, D, S):
    R̂(x, y) = R(y, x) · Σ_{x0} q_{t|0}(y|x0) p0t(x0|x) / q_{t|0}(x|x0)."""
    if rate_param != "p0t":
        raise NotImplementedError(
            f"rate_param={rate_param!r}: the CRM ratio path is ported with "
            "the CRM losses in a later slice"
        )
    qt0, rate = _shared_mats(process, t)
    N, D, S = logits.shape
    xl = x.long()
    p0t = torch.softmax(logits, dim=-1)
    qt0_denom = qt0.t()[xl] + eps  # [n, d, s] = qt0[s, x[n, d]]
    forward_rates = rate.t()[xl]  # R(s, x[n, d])
    ratio = ((p0t / qt0_denom).reshape(N * D, S) @ qt0).reshape(N, D, S)
    return forward_rates * ratio


def poisson_inversion(generator, lam, max_k: int = 12, u=None):
    """Poisson counts by CDF inversion with a fixed unrolled series (exact
    up to P(N > max_k)); `u` may be injected, else drawn from `generator`."""
    if u is None:
        u = torch.rand(lam.shape, generator=generator, device=lam.device)
    pmf = torch.exp(-lam)  # P(N = 0)
    cdf = pmf
    n = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    for k in range(1, max_k + 1):
        n = n + (u > cdf).to(torch.int32)
        pmf = pmf * lam / k
        cdf = cdf + pmf
    return n


def _poisson_jump_update(generator, x, rates, h, S, is_ordinal: bool,
                         exact_poisson: bool = False, u=None):
    """Poisson tau-leap state update: summed ordinal offset, clamp to
    [0, S-1]; non-ordinal mode rejects dims with >1 total jumps."""
    if exact_poisson:
        jump_nums = torch.poisson(rates * h, generator=generator).to(torch.int32)
    else:
        jump_nums = poisson_inversion(generator, rates * h, u=u)
    if not is_ordinal:
        jump_num_sum = torch.sum(jump_nums, dim=2)
        jump_nums = jump_nums * (jump_num_sum <= 1)[:, :, None]
    diff = torch.arange(S, device=x.device, dtype=torch.int32)[None, None, :] - x[:, :, None]
    overall_jump = torch.sum(jump_nums * diff, dim=2)
    return torch.clamp(x + overall_jump, 0, S - 1).to(torch.int32)


def gumbel_noise(generator, shape, device):
    """Standard Gumbel draws -log(-log(u)), finite for every u in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _categorical_euler_update(generator, x, rev_rates, h, g=None):
    """LBJF / Euler categorical step: the Euler posterior's log-probs, then
    a Gumbel-max draw argmax(logp + g); `g` (N, D, S) may be injected, else
    it is drawn from `generator`."""
    logp = rate_kernels.euler_posterior(rev_rates, x, h)
    if g is None:
        g = gumbel_noise(generator, logp.shape, logp.device)
    return torch.argmax(logp + g, dim=-1).to(torch.int32)


def _time_grid(max_t: float, min_t: float, num_steps: int):
    """(t_k, h_k) float32 pairs: float64 linspace ⊕ [0], then cast."""
    ts = np.concatenate((np.linspace(max_t, min_t, num_steps), np.array([0.0])))
    hs = ts[:-1] - ts[1:]
    return ts[:-1].astype(np.float32), hs.astype(np.float32)


def _denoise_argmax(model, params, x, min_t, N):
    """Final argmax denoise p_{0|min_t}."""
    t_ones = torch.full((N,), min_t, dtype=torch.float32, device=x.device)
    p = torch.softmax(model.apply(params, x, t_ones), dim=-1)
    return torch.argmax(p, dim=-1).to(torch.int32)


class _SamplerBase:
    """Common config unpack shared by the registered samplers."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.D = cfg.model.concat_dim
        self.S = cfg.data.S
        self.num_steps = cfg.sampler.num_steps
        self.min_t = cfg.sampler.min_t
        self.max_t = cfg.training.get("max_t", 1.0)
        self.initial_dist = cfg.sampler.initial_dist
        self.initial_dist_std = cfg.model.get("Q_sigma", None)
        self.eps_ratio = cfg.sampler.eps_ratio
        self.num_corrector_steps = cfg.sampler.get("num_corrector_steps", 0)
        self.corrector_entry_time = cfg.sampler.get("corrector_entry_time", 0.0)
        self.is_ordinal = cfg.sampler.get("is_ordinal", True)
        self.exact_poisson = bool(cfg.sampler.get("exact_poisson", False))
        self.loss_name = cfg.loss.name
        self.rate_param = rate_param_from_loss(self.loss_name)
        self.logit_type = cfg.loss.get("logit_type", "direct")
        self.log_prob_kind = cfg.model.get("log_prob", "cat")
        if self.log_prob_kind != "cat":
            raise NotImplementedError(
                f"model.log_prob={self.log_prob_kind!r}: EBM logits are "
                "ported with the EBM models in a later slice"
            )
        # a corrector whose entry time lies below the time grid never runs
        # (the shipped configs: corrector_entry_time=0.0)
        if self.corrector_entry_time < self.min_t:
            self.num_corrector_steps = 0
        self.use_fused_update = bool(cfg.sampler.get("use_fused_update", False))
        # sampler.remat_scan_body and sampler.host_chunk_steps shape the
        # JAX package's compiled scan; the eager loop here has neither

    def _fused_applicable(self):
        # the fused kernel implements only the CDF-inversion Poisson, so
        # exact_poisson wins over use_fused_update
        return (
            self.use_fused_update
            and not self.exact_poisson
            and self.rate_param == "p0t"
        )

    def _logits(self, model, params, x, t: float):
        t_ones = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        return model.apply(params, x, t_ones)

    def _rev_rates(self, model, params, x, t: float, mats=None):
        """Shared-timestep reverse rates through the reverse-rates kernel,
        (N, D, S) with the entry at x already 0 (the JAX package's
        `_rev_rates` leaves it; every caller masks it). `mats` takes the
        (qt0, rate) tables at t where the caller has them already."""
        if self.rate_param != "p0t":
            raise NotImplementedError(
                f"rate_param={self.rate_param!r}: the CRM ratio path is "
                "ported with the CRM losses in a later slice"
            )
        logits = self._logits(model, params, x, t)
        qt0, rate = mats if mats is not None else _shared_mats(model.process, t)
        xl = x.long()
        qt0_denom = qt0.t()[xl] + self.eps_ratio  # [n, d, s] = qt0[s, x[n, d]]
        forward_rates = rate.t()[xl]  # R(s, x[n, d])
        return rate_kernels.reverse_rates(logits, qt0_denom, qt0, forward_rates, x)

    def _corrector_rates(self, model, params, x, t: float):
        """Corrector rates R̂(x, ·) + R(x, ·), 0 at x."""
        mats = _shared_mats(model.process, t)
        rev = self._rev_rates(model, params, x, t, mats)
        transpose_forward = mats[1][x.long()]  # R(x, ·) rows
        return indexing.zero_at(transpose_forward + rev, x)

    def time_grid(self):
        """(t_k, h_k) of the steps: float32, as the JAX scan carries them."""
        return _time_grid(self.max_t, self.min_t, self.num_steps)

    def _changes_per(self, N: int) -> int:
        """What a step's count of changed dims is divided by."""
        return N

    @torch.inference_mode()
    def sample(self, model, params, generator: torch.Generator, N: int,
               label=None, cfg_scale: float = 0.0):
        """N samples and the per-step change rate, both as numpy arrays.

        `generator` must live on the model's device."""
        if label is not None or cfg_scale:
            raise NotImplementedError(
                "label-conditional sampling and CFG belong to DiT, ported in "
                "a later slice"
            )
        x, changes = self._sample_loop(model, params, generator, N)
        return x.cpu().numpy().astype(int), changes.cpu().numpy()

    def _sample_loop(self, model, params, generator, N):
        """init -> one update per grid point (each followed by the corrector
        steps once t <= corrector_entry_time) -> argmax denoise."""
        device = model.device
        x = get_initial_samples(
            generator, N, self.D, self.S, self.initial_dist,
            self.initial_dist_std, device=device,
        )
        ts, hs = self.time_grid()
        # one draw per batch; the fused kernel's key is (base, step)
        base = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=device).item())
        # float32 on both sides, as the JAX scan compares them
        entry = np.float32(self.corrector_entry_time)
        changes = []
        for i in range(len(ts)):
            t, h = float(ts[i]), float(hs[i])
            x_new = self.step(model, params, x, t, h, generator=generator,
                              seed=base | (i << 32))
            changes.append(torch.sum(x != x_new) / self._changes_per(N))
            if self.num_corrector_steps > 0 and ts[i] <= entry:
                for _ in range(self.num_corrector_steps):
                    x_new = self.corrector_step(model, params, x_new, t, h,
                                                generator=generator)
            x = x_new
        if self.loss_name in TAULDR_LOSSES:
            x = _denoise_argmax(model, params, x, self.min_t, N)
        return x, torch.stack(changes)

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None):
        raise NotImplementedError

    def corrector_step(self, model, params, x, t: float, h: float, *,
                       generator=None, u=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no corrector branch"
        )


# ---------------------------------------------------------------------------
# TauL: tau-leaping
# ---------------------------------------------------------------------------


@registry.samplers.register
class TauL(_SamplerBase):
    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None):
        """One tau-leap step from (N, D) int32 x at time t with step h.

        Fused: one kernel launch keyed by `seed`. Unfused: uniforms from
        `generator`. `u` (N, D, S) injects the uniforms on either branch."""
        if self._fused_applicable():
            logits = self._logits(model, params, x, t)
            qt0, rate = _shared_mats(model.process, t)
            return fused_tau_leap_update(
                logits, x, x, qt0, rate, h, self.eps_ratio, seed,
                mode="poisson", is_ordinal=self.is_ordinal, u=u,
            )
        rev = self._rev_rates(model, params, x, t)  # 0 at x
        return _poisson_jump_update(
            generator, x, rev, h, self.S, self.is_ordinal, self.exact_poisson,
            u=u,
        )

    def corrector_step(self, model, params, x, t: float, h: float, *,
                       generator=None, u=None):
        """One corrector step: Poisson jumps at the corrector rates."""
        corrector = self._corrector_rates(model, params, x, t)
        return _poisson_jump_update(
            generator, x, corrector, h, self.S, self.is_ordinal,
            self.exact_poisson, u=u,
        )


# ---------------------------------------------------------------------------
# LBJF: Euler / locally-balanced jump factorization
# ---------------------------------------------------------------------------


@registry.samplers.register
class LBJF(_SamplerBase):
    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, g=None):
        """One Euler step: reverse rates, posterior, categorical draw.
        `g` (N, D, S) injects the Gumbel noise."""
        rev = self._rev_rates(model, params, x, t)
        return _categorical_euler_update(generator, x, rev, h, g=g)

    def corrector_step(self, model, params, x, t: float, h: float, *,
                       generator=None, g=None):
        """One corrector step: an Euler step at the corrector rates."""
        corrector = self._corrector_rates(model, params, x, t)
        return _categorical_euler_update(generator, x, corrector, h, g=g)


# ---------------------------------------------------------------------------
# MidPointTauL: midpoint tau-leaping
# ---------------------------------------------------------------------------


@registry.samplers.register
class MidPointTauL(_SamplerBase):
    """Midpoint tau-leaping; the state-change matrix is the ordinal
    difference, state_change[s, x] = s - x."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_corrector_steps = 0  # the midpoint scheme has no corrector

    def time_grid(self):
        """float32 t_k and the constant float64 h: steps run while
        t - h/2 > min_t."""
        h = (self.max_t - self.min_t) / self.num_steps
        n_steps = int(np.ceil((self.max_t - 0.5 * h - self.min_t) / h - 1e-9))
        return ((self.max_t - h * np.arange(n_steps)).astype(np.float32),
                np.full(n_steps, h))

    def _changes_per(self, N: int) -> int:
        return N * self.D

    def _state_change(self, x):
        iota = torch.arange(self.S, dtype=torch.float32, device=x.device)
        return iota[None, None, :] - x[:, :, None].float()

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None):
        """One midpoint step: the expected drift over h/2 gives x', then a
        full Poisson step from x at the rates of (x', t - h/2). Fused, each
        half is one launch of the fused kernel. `u` (N, D, S) injects the
        Poisson step's uniforms."""
        S = self.S
        t_05 = float(np.float32(t) - np.float32(0.5 * h))  # float32, as t is
        if self._fused_applicable():
            logits = self._logits(model, params, x, t)
            qt0, rate = _shared_mats(model.process, t)
            x_prime = fused_tau_leap_update(
                logits, x, x, qt0, rate, 0.5 * h, self.eps_ratio, seed,
                mode="expected", is_ordinal=self.is_ordinal,
            )
            logits_p = self._logits(model, params, x_prime, t_05)
            qt0_05, rate_05 = _shared_mats(model.process, t_05)
            return fused_tau_leap_update(
                logits_p, x_prime, x, qt0_05, rate_05, h, self.eps_ratio, seed,
                mode="poisson", is_ordinal=self.is_ordinal, u=u,
            )

        # half-step expected drift -> x'
        rev = self._rev_rates(model, params, x, t)  # 0 at x
        change = torch.round(
            0.5 * h * torch.sum(rev * self._state_change(x), dim=-1)
        ).to(torch.int32)
        x_prime = torch.clamp(x + change, 0, S - 1)

        # full step with rates at (x', t - h/2), applied from x
        rev_p = self._rev_rates(model, params, x_prime, t_05)  # 0 at x'
        if self.exact_poisson:
            flips = torch.poisson(rev_p * h, generator=generator).to(torch.int32)
        else:
            flips = poisson_inversion(generator, rev_p * h, u=u)
        if not self.is_ordinal:
            tot = torch.sum(flips, dim=-1, keepdim=True)
            flips = flips * (tot <= 1)
        avg_offset = torch.sum(
            flips.float() * self._state_change(x_prime), dim=-1
        ).to(torch.int32)
        return torch.clamp(x + avg_offset, 0, S - 1).to(torch.int32)


for _alias, _target in (
    ("ElboTauL", "TauL"), ("TauLeaping", "TauL"), ("CRMLBJF", "LBJF"),
    ("LBJFSampling", "LBJF"), ("CRMebmLBJF", "LBJF"),
):
    registry.samplers.alias(_alias, _target)
