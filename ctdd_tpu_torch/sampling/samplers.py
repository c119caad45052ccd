"""Reverse-CTMC samplers: TauL on the p0t path.

Counterpart of the TauL pieces of ctdd_tpu/sampling/samplers.py. The JAX
package scans a compiled step over a precomputed time grid; here the same
step runs in an eager Python loop over the same float32 grid. With
`sampler.use_fused_update` every step's update is one launch of the fused
tau-leap kernel (ops/fused_update.py); otherwise it is the plain chain of
reverse rates and Poisson jumps.

Randomness comes from an explicit `torch.Generator` on the model's device:
it draws x_T, the unfused path's uniforms and, once per batch, the base word
of the fused kernel's Philox key (the second word is the step index).
"""

from __future__ import annotations

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing
from ctdd_tpu_torch.ops.fused_update import fused_tau_leap_update

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
    initial_dist_std: float = None, device="cpu",
) -> torch.Tensor:
    """Uniform or discretized-Gaussian prior x_T, (N, D) int32."""
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
        if self.num_corrector_steps > 0:
            raise NotImplementedError(
                "a live corrector (corrector_entry_time >= min_t) is ported "
                "with the LBJF and corrector path in a later slice"
            )
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
        """init -> num_steps updates -> argmax denoise."""
        device = model.device
        x = get_initial_samples(
            generator, N, self.D, self.S, self.initial_dist,
            self.initial_dist_std, device=device,
        )
        ts, hs = _time_grid(self.max_t, self.min_t, self.num_steps)
        # one draw per batch; the fused kernel's key is (base, step)
        base = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=device).item())
        changes = []
        for i in range(self.num_steps):
            x_new = self.step(model, params, x, float(ts[i]), float(hs[i]),
                              generator=generator, seed=base | (i << 32))
            changes.append(torch.sum(x != x_new) / N)
            x = x_new
        if self.loss_name in TAULDR_LOSSES:
            x = _denoise_argmax(model, params, x, self.min_t, N)
        return x, torch.stack(changes)

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None):
        raise NotImplementedError


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
        t_ones = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        logits = model.apply(params, x, t_ones)
        if self._fused_applicable():
            qt0, rate = _shared_mats(model.process, t)
            return fused_tau_leap_update(
                logits, x, x, qt0, rate, h, self.eps_ratio, seed,
                mode="poisson", is_ordinal=self.is_ordinal, u=u,
            )
        rev = reverse_rates_shared(
            model.process, logits, x, t, rate_param=self.rate_param,
            logit_type=self.logit_type, eps=self.eps_ratio,
        )
        rev = rev * indexing.onehot_mask(x, self.S)
        return _poisson_jump_update(
            generator, x, rev, h, self.S, self.is_ordinal, self.exact_poisson,
            u=u,
        )


for _alias in ("ElboTauL", "TauLeaping"):
    registry.samplers.alias(_alias, "TauL")
