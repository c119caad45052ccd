"""Reverse-CTMC samplers: TauL, TAULStepSize, LBJF, MidPointTauL, PCTauL,
ExactSampling, the prefix-conditional ConditionalTauLeaping,
ConditionalPCTauLeaping and ConditionalLBJF, and `lbjf_corrector_step`.

Counterpart of ctdd_tpu/sampling/samplers.py. The JAX package scans a
compiled step over a precomputed time grid; here the same step runs in an
eager Python loop over the same float32 grid.

- TauL: with `sampler.use_fused_update` every step's update is one launch of
  the fused tau-leap kernel (ops/fused_update.py); otherwise reverse rates
  (ops/rate_kernels.py) and Poisson jumps. TAULStepSize is unfused TauL that
  also returns per-step traces of the jump proposals.
- LBJF: reverse rates, then the Euler posterior and its Gumbel-max
  categorical draw (both ops/rate_kernels.py); on the card the posterior
  and the draw are one launch of the posterior kernel's draw mode.
- The reverse rates come from the p0t formula (the tauLDR losses) through
  the reverse-rates kernel, or from the network's log-probability ratios
  (the SDDM/CRM/EBM losses, `rate_param="ratio"`) in plain torch; the Euler
  posterior kernel runs on either. An EBM (`model.log_prob` "ebm" or
  "bin_ebm") gives its per-dim logits through the mutation enumerators of
  losses/losses.py.
- MidPointTauL: fused, two launches of the fused kernel per step ("expected"
  over h/2, then "poisson" from the midpoint state); unfused, two
  reverse-rate passes.
- PCTauL: the tauLDR predictor-corrector on its own grid, the corrector at
  t - h with a step of `corrector_step_size_multiplier` * h.
- ExactSampling: the exact bridge step through q_{t-h|0} and q_{t|t-h}, a
  plain product and a Gumbel-max draw (no kernel: JAX's step is an einsum).
- The conditional samplers hold the first `condition_dim` states at a clean
  prefix; their p0t rates go through the reverse-rates kernel with the
  shared (S, S) table, and ConditionalLBJF's update through the posterior
  kernel.

- Labels: `sample(label=, cfg_scale=)` binds the class ids into the model
  handle (`bind_label`) for every step and the final denoise, guided in
  logit space when cfg_scale > 0 (two network forwards a step, the null
  label at row S); the conditional samplers take them the same way.

Randomness comes from an explicit `torch.Generator` on the model's device:
it draws x_T, the uniforms and Gumbel noise of the unfused updates and, once
per batch, the base word of the in-kernel Philox keys (the second word is
the step index): the fused tau-leap kernel's, and on the card the LBJF
draw's, whose substep word is 0 for a step's predictor and k + 1 for its
k-th corrector step. On the CPU the LBJF draw takes its Gumbel noise from
the generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing, rate_kernels
from ctdd_tpu_torch.ops.fused_update import fused_tau_leap_update
from ctdd_tpu_torch.ops.logprob import log_prob_from_logits, logprob_with_logits
from ctdd_tpu_torch.utils.device import resolve_device
from ctdd_tpu_torch.utils.math import categorical, gumbel_noise, safe_log
from ctdd_tpu_torch.utils.trace import SAMPLE_DENOISE, SAMPLE_STEP, SAMPLE_TABLES, span

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
    """R̂_t(x -> ·) per dim with a timestep per sample, t (N,): (rates,
    ratio), both (N, D, S); the rates are 0 at x, the ratio is not masked.

    p0t:   R̂(x, y) = R(y, x) · Σ_{x0} q_{t|0}(y|x0) p0t(x0|x) / q_{t|0}(x|x0),
           through the reverse-rates kernel
    ratio: R̂(x, y) = exp(ll_all - ll_xt) · R(x, y), in plain torch (the
           kernel computes only the p0t formula); at x this product is the
           negative diagonal R(x, x), so it is zeroed here"""
    if rate_param == "ratio":
        ll_all, ll_xt = logprob_with_logits(logit_type, model.process, x, t, logits)
        ratio = torch.exp(ll_all - ll_xt[..., None])
        return indexing.zero_at(ratio * model.rate_mat(x, t), x), ratio
    if rate_param != "p0t":
        raise ValueError(f"unknown rate_param {rate_param}")
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
    with span(SAMPLE_TABLES):
        t1 = torch.full((1,), t, dtype=torch.float32, device=process.device)
        return process.transition(t1)[0], process.rate(t1)[0]


def _ratio_rates_shared(qt0, rate, logits, x, logit_type: str):
    """The ratio branch at a shared timestep: exp(ll_all - ll_xt) · R(x, ·),
    zeroed at x (where the product is the negative diagonal R(x, x))."""
    log_prob = log_prob_from_logits(logit_type, logits, qt0)
    ll_xt = torch.gather(log_prob, -1, x.long()[..., None])
    return indexing.zero_at(torch.exp(log_prob - ll_xt) * rate[x.long()], x)


def reverse_rates_shared(
    process, logits, x, t: float, *, rate_param: str, logit_type: str,
    eps: float,
):
    """Shared-timestep reverse rates R̂_t(x -> ·) per dim, (N, D, S).
    p0t (unmasked, as in JAX): R̂(x, y) = R(y, x) · Σ_{x0} q_{t|0}(y|x0)
    p0t(x0|x) / q_{t|0}(x|x0). ratio: exp(ll_all - ll_xt) · R(x, y), 0 at x."""
    qt0, rate = _shared_mats(process, t)
    if rate_param == "ratio":
        return _ratio_rates_shared(qt0, rate, logits, x, logit_type)
    if rate_param != "p0t":
        raise ValueError(f"unknown rate_param {rate_param}")
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
                         exact_poisson: bool = False, u=None, traces=None):
    """Poisson tau-leap state update: summed ordinal offset, clamp to
    [0, S-1]; non-ordinal mode rejects dims with >1 total jumps. A `traces`
    dict receives the shares of dims that propose more than one jump
    (`frac_multi`, before the rejection), a net move (`frac_jumped`) and a
    move that survives the clamp (`frac_clipped`)."""
    if exact_poisson:
        jump_nums = torch.poisson(rates * h, generator=generator).to(torch.int32)
    else:
        jump_nums = poisson_inversion(generator, rates * h, u=u)
    if traces is not None or not is_ordinal:
        jump_num_sum = torch.sum(jump_nums, dim=2)
    if traces is not None:
        traces["frac_multi"] = torch.mean((jump_num_sum > 1).float())
    if not is_ordinal:
        jump_nums = jump_nums * (jump_num_sum <= 1)[:, :, None]
    diff = torch.arange(S, device=x.device, dtype=torch.int32)[None, None, :] - x[:, :, None]
    xp = x + torch.sum(jump_nums * diff, dim=2)
    x_new = torch.clamp(xp, 0, S - 1).to(torch.int32)
    if traces is not None:
        traces["frac_jumped"] = torch.mean((xp != x).float())
        traces["frac_clipped"] = torch.mean((x_new != x).float())
    return x_new


def _categorical_euler_update(generator, x, rev_rates, h, g=None, *, seed=None,
                              substep: int = 0):
    """LBJF / Euler categorical step argmax(logp + g) of the Euler posterior's
    log-probs, through `rate_kernels.euler_posterior_draw`, with `g` (N, D, S)
    injected, or else on the CPU drawn from `generator`, and off the CPU
    made in the kernel (one launch of its draw mode) from its Philox stream
    keyed by (`seed`, `substep`); without a `seed` the key is drawn from
    `generator` (one host read)."""
    if g is None:
        if rev_rates.device.type == "cpu":
            g = gumbel_noise(generator, rev_rates.shape, rev_rates.device)
        elif seed is None:
            seed = _batch_key(generator, rev_rates.device)
    return rate_kernels.euler_posterior_draw(rev_rates, x, h, seed=seed or 0,
                                             substep=substep, g=g)


def _batch_key(generator, device) -> int:
    """The base word of a batch's Philox keys, drawn on the generator's
    device: one draw (and one host read) per batch; step i keys its draws
    with base | (i << 32)."""
    if generator is not None:
        device = generator.device
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device).item())


def _time_grid(max_t: float, min_t: float, num_steps: int):
    """(t_k, h_k) float32 pairs: float64 linspace ⊕ [0], then cast."""
    ts = np.concatenate((np.linspace(max_t, min_t, num_steps), np.array([0.0])))
    hs = ts[:-1] - ts[1:]
    return ts[:-1].astype(np.float32), hs.astype(np.float32)


def _pc_time_grid(min_t: float, num_steps: int):
    """The predictor-corrector grid: float64 linspace(1, min_t + 1/num_steps,
    num_steps), its num_steps - 1 (t_k, h_k) pairs cast to float32."""
    ts = np.linspace(1.0, min_t + 1.0 / num_steps, num_steps)
    return ts[:-1].astype(np.float32), (ts[:-1] - ts[1:]).astype(np.float32)


def _denoise_argmax(model, params, x, min_t, N):
    """Final argmax denoise p_{0|min_t}."""
    with span(SAMPLE_DENOISE):
        t_ones = torch.full((N,), min_t, dtype=torch.float32, device=x.device)
        p = torch.softmax(model.apply(params, x, t_ones), dim=-1)
        return torch.argmax(p, dim=-1).to(torch.int32)


def bind_label(model, label, cfg_scale: float, S: int):
    """`model` with `label` bound for every forward (classifier-free guided
    when `cfg_scale` > 0, the null label being the LabelEmbedder's row S);
    `model` itself without a label, whatever `cfg_scale`. A model that is
    not label-conditional refuses a label."""
    if label is None:
        return model
    if not model.has_label:
        raise ValueError(f"model {model.cfg.model.name} is not label-conditional")
    label = torch.as_tensor(np.asarray(label), dtype=torch.long, device=model.device)
    return dataclasses.replace(model, bound_label=label, cfg_scale=float(cfg_scale),
                               null_label=S)


class _SamplerBase:
    """Common config unpack shared by the registered samplers."""

    # the LBJF samplers: their steps and corrector steps take the batch's
    # Philox key (seed, substep) for the draw
    keyed_draw = False

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
        self.corrector_step_size_multiplier = cfg.sampler.get(
            "corrector_step_size_multiplier", 1.5)
        self.is_ordinal = cfg.sampler.get("is_ordinal", True)
        self.exact_poisson = bool(cfg.sampler.get("exact_poisson", False))
        self.loss_name = cfg.loss.name
        self.rate_param = rate_param_from_loss(self.loss_name)
        self.logit_type = cfg.loss.get("logit_type", "direct")
        # "ebm" / "bin_ebm": the network returns energies, and the per-dim
        # logits come from the mutation enumerators (`_logits`)
        self.log_prob_kind = cfg.model.get("log_prob", "cat")
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
            and self.log_prob_kind == "cat"
        )

    def _logits(self, model, params, x, t: float):
        """(N, D, S) logits at a shared time; an EBM's energies through the
        all-mutation or the bit-flip enumerator."""
        t_ones = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        if self.log_prob_kind == "ebm":
            from ctdd_tpu_torch.losses.losses import ebm_all_mutation_logits

            return ebm_all_mutation_logits(model, params, x, t_ones, self.S)
        if self.log_prob_kind == "bin_ebm":
            from ctdd_tpu_torch.losses.losses import bin_ebm_flip_logits

            return bin_ebm_flip_logits(model, params, x, t_ones)
        return model.apply(params, x, t_ones)

    def _rev_rates_inputs(self, model, params, x, t: float, mats=None):
        """The reverse-rates kernel's inputs at a shared timestep on the p0t
        path: (logits, qt0_denom, qt0, forward_rates). `mats` takes the (qt0,
        rate) tables at t where the caller has them already."""
        logits = self._logits(model, params, x, t)
        qt0, rate = mats if mats is not None else _shared_mats(model.process, t)
        xl = x.long()
        qt0_denom = qt0.t()[xl] + self.eps_ratio  # [n, d, s] = qt0[s, x[n, d]]
        forward_rates = rate.t()[xl]  # R(s, x[n, d])
        return logits, qt0_denom, qt0, forward_rates

    def _rev_rates(self, model, params, x, t: float, mats=None):
        """Shared-timestep reverse rates, (N, D, S) with the entry at x
        already 0 (the JAX package's `_rev_rates` leaves it; every caller
        masks it): on the p0t path through the reverse-rates kernel, on the
        ratio path in plain torch."""
        if self.rate_param == "ratio":
            qt0, rate = mats if mats is not None else _shared_mats(model.process, t)
            return _ratio_rates_shared(qt0, rate, self._logits(model, params, x, t), x,
                                       self.logit_type)
        return rate_kernels.reverse_rates(
            *self._rev_rates_inputs(model, params, x, t, mats), x)

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

    def _denoises(self) -> bool:
        """Whether the samples end with the argmax of p0t at min_t: for the
        tauLDR losses."""
        return self.loss_name in TAULDR_LOSSES

    @torch.inference_mode()
    def sample(self, model, params, generator: torch.Generator, N: int,
               label=None, cfg_scale: float = 0.0):
        """N samples and the per-step change rates, as numpy arrays.

        `generator` must live on the model's device. `label` (N class ids)
        and `cfg_scale` condition every network call, the final denoise
        included, on a label-conditional model (`bind_label`)."""
        model = bind_label(model, label, cfg_scale, self.S)
        x, traces = self._sample_loop(model, params, generator, N)
        return x.cpu().numpy().astype(int), traces.cpu().numpy()

    def _sample_loop(self, model, params, generator, N):
        """init -> one update per grid point (each followed by the corrector
        steps once t <= corrector_entry_time) -> argmax denoise."""
        device = model.device
        x = get_initial_samples(
            generator, N, self.D, self.S, self.initial_dist,
            self.initial_dist_std, device=device,
        )
        ts, hs = self.time_grid()
        base = _batch_key(generator, device)
        # float32 on both sides, as the JAX scan compares them
        entry = np.float32(self.corrector_entry_time)
        traces = []
        for i in range(len(ts)):
            t, h = float(ts[i]), float(hs[i])
            with span(SAMPLE_STEP):
                x_new = self.step(model, params, x, t, h, generator=generator,
                                  seed=base | (i << 32))
            traces.append(torch.sum(x != x_new) / self._changes_per(N))
            if self.num_corrector_steps > 0 and ts[i] <= entry:
                for k in range(self.num_corrector_steps):
                    key = (dict(seed=base | (i << 32), substep=k + 1)
                           if self.keyed_draw else {})
                    with span(SAMPLE_STEP):
                        x_new = self.corrector_step(model, params, x_new, t, h,
                                                    generator=generator, **key)
            x = x_new
        if self._denoises():
            x = _denoise_argmax(model, params, x, self.min_t, N)
        return x, torch.stack(traces)

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


@registry.samplers.register
class TAULStepSize(TauL):
    """Unfused tau-leaping whose `sample` returns, per step, the share of
    dims that propose a net jump (`frac_jumped`), more than one jump
    (`frac_multi`) and a move that survives the [0, S-1] clamp
    (`frac_clipped`), each a (num_steps,) array; correctors as TauL's."""

    _run = None  # the steps' traces while `sample` runs

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None, traces=None):
        """TauL's unfused step; fills the dict `traces` when one is given,
        and adds one to the run's while `sample` runs."""
        if traces is None and self._run is not None:
            traces = {}
            self._run.append(traces)
        rev = self._rev_rates(model, params, x, t)  # 0 at x
        return _poisson_jump_update(generator, x, rev, h, self.S, self.is_ordinal,
                                    self.exact_poisson, u=u, traces=traces)

    def sample(self, model, params, generator: torch.Generator, N: int,
               label=None, cfg_scale: float = 0.0):
        """N samples and the three traces, each a (num_steps,) numpy array."""
        self._run = []
        try:
            x, _ = super().sample(model, params, generator, N, label, cfg_scale)
            run = self._run
        finally:
            self._run = None
        return x, {k: torch.stack([tr[k] for tr in run]).cpu().numpy() for k in run[0]}


# ---------------------------------------------------------------------------
# LBJF: Euler / locally-balanced jump factorization
# ---------------------------------------------------------------------------


@registry.samplers.register
class LBJF(_SamplerBase):
    keyed_draw = True

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed=None, g=None):
        """One Euler step: reverse rates, posterior, categorical draw keyed
        by (`seed`, substep 0) on the card. `g` (N, D, S) injects the Gumbel
        noise."""
        rev = self._rev_rates(model, params, x, t)
        return _categorical_euler_update(generator, x, rev, h, g=g, seed=seed)

    def corrector_step(self, model, params, x, t: float, h: float, *,
                       generator=None, seed=None, substep: int = 1, g=None):
        """One corrector step: an Euler step at the corrector rates, its
        draw keyed by (`seed`, `substep`) on the card."""
        corrector = self._corrector_rates(model, params, x, t)
        return _categorical_euler_update(generator, x, corrector, h, g=g, seed=seed,
                                         substep=substep)


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


# ---------------------------------------------------------------------------
# PCTauL: the tauLDR predictor-corrector
# ---------------------------------------------------------------------------


@registry.samplers.register
class PCTauL(_SamplerBase):
    """Tau-leaping predictor on the p0t rates (whatever the loss) over the
    grid of `_pc_time_grid`; below the entry time, corrector steps at t - h
    with a step of `corrector_step_size_multiplier` * h. The prior's
    Gaussian std is 200."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.rate_param = "p0t"
        self.initial_dist_std = 200.0

    def time_grid(self):
        return _pc_time_grid(self.min_t, self.num_steps)

    def _changes_per(self, N: int) -> int:
        return N * self.D

    def _denoises(self) -> bool:
        return True

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, u=None):
        rev = self._rev_rates(model, params, x, t)  # 0 at x
        return _poisson_jump_update(generator, x, rev, h, self.S, True,
                                    self.exact_poisson, u=u)

    def corrector_step(self, model, params, x, t: float, h: float, *,
                       generator=None, u=None):
        t_corr = float(np.float32(t) - np.float32(h))  # float32, as the scan's t - h
        corrector = self._corrector_rates(model, params, x, t_corr)
        return _poisson_jump_update(generator, x, corrector,
                                    self.corrector_step_size_multiplier * h, self.S,
                                    True, self.exact_poisson, u=u)


# ---------------------------------------------------------------------------
# ExactSampling: the exact bridge step
# ---------------------------------------------------------------------------


@registry.samplers.register
class ExactSampling(_SamplerBase):
    """The reverse step through q_{t-h|0} and q_{t|t-h}, marginalized over
    the network's x0:

        p(x_{t-h} = k | x_t) ∝ Σ_s p0t(s | x_t) q_{t-h|0}(k | s) / q_{t|0}(x_t | s)
                                · q_{t|t-h}(x_t | k)

    with the 1/q_{t|0} bridge denominator the JAX package keeps (the
    original reference leaves it out). One (N·D, S) x (S, S) product and a
    Gumbel-max draw; no corrector and no final denoise."""

    def _denoises(self) -> bool:
        return False

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_corrector_steps = 0

    def _changes_per(self, N: int) -> int:
        return N * self.D

    def step(self, model, params, x, t: float, h: float, *, generator=None,
             seed: int = 0, g=None):
        """One exact step; `g` (N, D, S) injects the Gumbel noise."""
        N, D = x.shape
        S = self.S
        p0t = torch.softmax(self._logits(model, params, x, t), dim=-1)
        t1 = torch.full((1,), t, dtype=torch.float32, device=x.device)
        q_teps_0 = model.transition(t1 - h)[0]  # (S, S)
        q_t_teps = model.transit_between(t1 - h, t1)[0]  # (S, S)
        qt0 = model.transition(t1)[0]
        xl = x.long()
        trans_cols = q_t_teps.t()[xl]  # q_{t|t-h}(x_t | k) over k
        qt0_denom = qt0.t()[xl] + self.eps_ratio  # q_{t|0}(x_t | s) over s
        marg = ((p0t / qt0_denom).reshape(N * D, S) @ q_teps_0).reshape(N, D, S)
        log_prob = safe_log(marg) + safe_log(trans_cols)
        if g is None:
            g = gumbel_noise(generator, log_prob.shape, log_prob.device)
        return torch.argmax(log_prob + g, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# prefix-conditional samplers
# ---------------------------------------------------------------------------


class _ConditionalBase(_SamplerBase):
    """The first `sampler.condition_dim` states are a clean prefix (the
    `conditioner`); the chain runs over the other `sample_D`. `sample`
    returns [conditioner | argmax p0t at min_t] as a numpy array."""

    # whether `sampler.noise_prefix` applies (ConditionalPCTauLeaping
    # ignores it, as in JAX)
    noises_prefix = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.condition_dim = cfg.sampler.condition_dim
        self.total_D = cfg.data.shape[0]
        self.sample_D = self.total_D - self.condition_dim
        self.reject_multiple_jumps = cfg.sampler.get("reject_multiple_jumps", False)
        self.noise_prefix = cfg.sampler.get("noise_prefix", False)
        if self.initial_dist != "gaussian":
            self.initial_dist_std = None

    def time_grid(self):
        return _time_grid(1.0, self.min_t, self.num_steps)

    def _cond_logits(self, model, params, conditioner, x, t: float):
        """The network on [conditioner | x] at a shared time, its logits at
        the sampled positions (contiguous)."""
        t_ones = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
        logits = model.apply(params, torch.cat([conditioner, x], dim=1), t_ones)
        return logits[:, self.condition_dim:, :].contiguous()

    def _prefix_at_t(self, model, generator, conditioner, t: float, g=None):
        """The clean prefix forward-diffused to t: one fresh draw of
        q_{t|0}(·|prefix) per step (`sampler.noise_prefix`); `g` (N, P, S)
        injects the Gumbel noise."""
        qt0, _ = _shared_mats(model.process, t)
        logits = safe_log(qt0[conditioner.long()])
        if g is None:
            return categorical(generator, logits)
        return torch.argmax(logits + g, dim=-1).to(torch.int32)

    def _step_conditioner(self, model, generator, conditioner, t: float, g=None):
        """The prefix the step's network sees: the clean one, or with
        `noise_prefix` a draw at t (the only extra randomness it takes)."""
        if not (self.noise_prefix and self.noises_prefix):
            return conditioner
        return self._prefix_at_t(model, generator, conditioner, t, g=g)

    def _cond_rates(self, model, params, conditioner, x, t: float):
        """(R(x, ·) rows, the p0t reverse rates 0 at x) on the sampled dims;
        the reverse rates through the reverse-rates kernel with the shared
        (S, S) table."""
        qt0, rate = _shared_mats(model.process, t)
        xl = x.long()
        rev = rate_kernels.reverse_rates(
            self._cond_logits(model, params, conditioner, x, t),
            qt0.t()[xl] + self.eps_ratio, qt0, rate.t()[xl], x)
        return rate[xl], rev

    def _jumps_ordinal(self) -> bool:
        return not self.reject_multiple_jumps

    @torch.inference_mode()
    def sample(self, model, params, generator: torch.Generator, N: int,
               conditioner=None, label=None, cfg_scale: float = 0.0):
        """N samples (N, total_D) given `conditioner` (N, condition_dim)
        ints; `generator` lives on the model's device; `label` and
        `cfg_scale` as the base's."""
        if conditioner is None or conditioner.shape[0] != N:
            raise ValueError(f"{type(self).__name__} needs a conditioner of {N} rows")
        model = bind_label(model, label, cfg_scale, self.S)
        conditioner = torch.as_tensor(np.asarray(conditioner), dtype=torch.int32,
                                      device=model.device)
        x = get_initial_samples(generator, N, self.sample_D, self.S, self.initial_dist,
                                self.initial_dist_std, device=model.device)
        ts, hs = self.time_grid()
        base = _batch_key(generator, model.device) if self.keyed_draw else 0
        entry = np.float32(self.corrector_entry_time)
        for i in range(len(ts)):
            t, h = float(ts[i]), float(hs[i])
            cond = self._step_conditioner(model, generator, conditioner, t)
            key = dict(seed=base | (i << 32)) if self.keyed_draw else {}
            x = self.step(model, params, cond, x, t, h, generator=generator, **key)
            if self.num_corrector_steps > 0 and ts[i] <= entry:
                for _ in range(self.num_corrector_steps):
                    x = self.corrector_step(model, params, conditioner, x, t, h,
                                            generator=generator)
        p0t = torch.softmax(self._cond_logits(model, params, conditioner, x, self.min_t),
                            dim=-1)
        x0max = torch.argmax(p0t, dim=-1).to(torch.int32)
        return torch.cat([conditioner, x0max], dim=1).cpu().numpy().astype(int)

    def step(self, model, params, conditioner, x, t: float, h: float, *,
             generator=None, u=None):
        """A Poisson tau-leap step of the sampled dims; `u` injects the
        uniforms."""
        _, rev = self._cond_rates(model, params, conditioner, x, t)
        return _poisson_jump_update(generator, x, rev, h, self.S, self._jumps_ordinal(),
                                    self.exact_poisson, u=u)


@registry.samplers.register
class ConditionalTauLeaping(_ConditionalBase):
    """Tau-leaping on the sampled dims; `reject_multiple_jumps` rejects a
    dim's multi-jump proposals (the original reference computes the mask and
    drops it)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_corrector_steps = 0


@registry.samplers.register
class ConditionalPCTauLeaping(_ConditionalBase):
    """The predictor-corrector on the sampled dims, on PCTauL's grid; the
    clean prefix throughout (`noise_prefix` is ignored, as in JAX)."""

    noises_prefix = False

    def time_grid(self):
        return _pc_time_grid(self.min_t, self.num_steps)

    def corrector_step(self, model, params, conditioner, x, t: float, h: float, *,
                       generator=None, u=None):
        t_corr = float(np.float32(t) - np.float32(h))
        tf, rv = self._cond_rates(model, params, conditioner, x, t_corr)
        return _poisson_jump_update(
            generator, x, indexing.zero_at(tf + rv, x),
            self.corrector_step_size_multiplier * h, self.S, self._jumps_ordinal(),
            self.exact_poisson, u=u)


@registry.samplers.register
class ConditionalLBJF(_ConditionalBase):
    """The Euler (LBJF) step on the sampled dims: the conditional reverse
    rates through the reverse-rates kernel, the posterior through the Euler
    posterior kernel, a Gumbel-max draw."""

    keyed_draw = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_corrector_steps = 0

    def step(self, model, params, conditioner, x, t: float, h: float, *,
             generator=None, seed=None, g=None):
        _, rev = self._cond_rates(model, params, conditioner, x, t)
        return _categorical_euler_update(generator, x, rev, h, g=g, seed=seed)


for _alias, _target in (
    ("ElboTauL", "TauL"), ("TauLeaping", "TauL"), ("CRMLBJF", "LBJF"),
    ("LBJFSampling", "LBJF"), ("CRMebmLBJF", "LBJF"),
):
    registry.samplers.alias(_alias, _target)


def lbjf_corrector_step(cfg, model, params, generator, xt, t: float, h: float, N: int,
                        xt_target=None, g=None, seed=None):
    """One standalone LBJF corrector step: the Euler posterior of the
    corrector rates ratio·R(x_t, ·) + R(x_t, ·) (the ratio of the network's
    log-probs at x_t), one-hot at `xt_target` (x_t by default), and a
    Gumbel-max draw, through the posterior kernel's draw mode; `g` (N, D, S)
    injects the noise, else on the CPU `generator` draws it and on the card
    `seed` (by default one drawn from `generator`) keys it, substep 0."""
    if xt_target is None:
        xt_target = xt
    t_ones = torch.full((N,), t, dtype=torch.float32, device=xt.device)
    logits = model.apply(params, xt, t_ones)
    ll_all, ll_xt = logprob_with_logits(cfg.loss.get("logit_type", "direct"),
                                        model.process, xt, t_ones, logits)
    fwd_rate = model.rate_mat(xt, t_ones)
    rev = torch.exp(ll_all - ll_xt[..., None]) * fwd_rate + fwd_rate
    return _categorical_euler_update(generator, xt_target, rev, h, g=g, seed=seed)
