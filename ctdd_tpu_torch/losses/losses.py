"""Training losses: the tauLDR family (CTElbo, NLL, CTElboLambda,
NLLOriginal), the prefix-conditional CondCTElbo and CondNLL, the SDDM ELBOs
(SDDMElbo, ScoreElbo), categorical ratio matching (CatRM, CatRMNLL), the
energy-based EBMAux and BinEBMAux, and the block-diffusion ELBO of the
absorbing process (BlockAbsorbingElbo).

Counterpart of ctdd_tpu/losses/losses.py. Each is a function of (model,
params, generator, batch): the generator draws the times, x_t and x̃ where
JAX splits a key, and dropout draws from the device's default generator
(the train step seeds it). The (B, D, S) x (B, S, S) products are
`torch.einsum`, as the JAX package keeps them outside any Pallas kernel.
Every loss takes `label` and drops it, as JAX's do, but NLLOriginal, which
conditions the network on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing
from ctdd_tpu_torch.ops.logprob import logprob_with_logits
from ctdd_tpu_torch.utils.math import (
    categorical, log1mexp, mean_cross_entropy, safe_log,
)


def get_loss(cfg):
    return registry.losses.get(cfg.loss.name)(cfg)


def _flatten_batch(minibatch: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, D); already-flat batches pass through."""
    if minibatch.ndim == 4:
        return minibatch.reshape(minibatch.shape[0], -1)
    return minibatch


def _sample_ts(generator, B: int, min_time: float, max_t: float,
               clamp_hi: Optional[float] = None) -> torch.Tensor:
    ts = torch.rand((B,), generator=generator, device=generator.device)
    ts = ts * (max_t - min_time) + min_time
    if clamp_hi is not None:
        ts = torch.clamp_max(ts, clamp_hi)
    return ts


def sample_xt(generator, qt0: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """x_t ~ Cat(q_{t|0}(·|x0)) per dimension, int32 (B, D)."""
    return categorical(generator, safe_log(indexing.rows(qt0, x0)))


def sample_xt_xtilde(
    generator, qt0: torch.Tensor, rate: torch.Tensor, x0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (x_t, x̃): x_t from q_{t|0}, then one uniformized jump of x_t.

    x̃ differs from x_t in exactly one dimension, chosen ∝ off-diagonal rate
    mass, with the new state drawn ∝ off-diagonal rates."""
    B, D = x0.shape
    x_t = sample_xt(generator, qt0, x0)
    rate_rows = indexing.zero_at(indexing.rows(rate, x_t), x_t)  # (B, D, S)
    dim_mass = rate_rows.sum(-1)  # (B, D)
    square_dims = categorical(generator, safe_log(dim_mass)).long()  # (B,)
    newval_probs = rate_rows[torch.arange(B, device=x0.device), square_dims]  # (B, S)
    newval = categorical(generator, safe_log(newval_probs))  # (B,)
    dim_onehot = torch.arange(D, device=x0.device)[None, :] == square_dims[:, None]
    x_tilde = torch.where(dim_onehot, newval[:, None], x_t)
    return x_t, x_tilde


# ---------------------------------------------------------------------------
# tauLDR CT-ELBO core
# ---------------------------------------------------------------------------


def _ctelbo_terms(model, params, generator, x0, ts, eps, one_forward_pass, train,
                  samples=None):
    """neg_elbo (scalar) and the training-pass logits.

    `samples` optionally injects (x_t, x_tilde); `ts` is the caller's."""
    qt0 = model.transition(ts)  # (B, S, S)
    rate = model.rate(ts)  # (B, S, S)
    if samples is None:
        x_t, x_tilde = sample_xt_xtilde(generator, qt0, rate, x0)
    else:
        x_t, x_tilde = samples

    x_logits = model.apply(params, x_t, ts, train=train)
    p0t_reg = torch.softmax(x_logits, dim=-1)
    if one_forward_pass:
        p0t_sig = p0t_reg
    else:
        p0t_sig = torch.softmax(model.apply(params, x_tilde, ts, train=train), dim=-1)
    reg_x = x_tilde if one_forward_pass else x_t
    return _neg_elbo(qt0, rate, x0, reg_x, x_tilde, p0t_reg, p0t_sig, eps), x_logits


def _neg_elbo(qt0, rate, x0, reg_x, x_tilde, p0t_reg, p0t_sig, eps):
    """The CT-ELBO's regularizer (at `reg_x`, with p0t_reg) and signal (at
    x̃, with p0t_sig) terms, each averaged over the batch, summed."""
    S = qt0.shape[-1]
    # -- regularizer term ----------------------------------------------------
    mask_reg = indexing.onehot_mask(reg_x, S)  # (B, D, S)
    qt0_denom_reg = indexing.cols(qt0, reg_x) + eps  # q_{t|0}(x̃ | ·) columns
    rate_vals_reg = indexing.cols(rate, reg_x)
    # (mask·R(·,x̃)) @ q_{t|0}ᵀ
    reg_tmp = torch.einsum("bds,bks->bdk", mask_reg * rate_vals_reg, qt0)
    reg_term = torch.sum((p0t_reg / qt0_denom_reg) * reg_tmp, dim=(1, 2))  # (B,)

    # -- signal term ---------------------------------------------------------
    qt0_denom_sig = indexing.cols(qt0, x_tilde) + eps
    inner_log_sig = torch.log(
        torch.einsum("bds,bsk->bdk", p0t_sig / qt0_denom_sig, qt0) + eps
    )

    x_tilde_mask = indexing.onehot_mask(x_tilde, S)
    outer_rate_sig = indexing.cols(rate, x_tilde)  # R(s, x̃_d) over s
    outer_qt0_numer_sig = indexing.rows(qt0, x0)  # q_{t|0}(s | x0_d) over s
    outer_qt0_denom_sig = indexing.elems(qt0, x0, x_tilde) + eps  # (B, D)

    outer_sum_sig = torch.sum(
        x_tilde_mask
        * outer_rate_sig
        * (outer_qt0_numer_sig / outer_qt0_denom_sig[:, :, None])
        * inner_log_sig,
        dim=(1, 2),
    )

    # -- Z_σ normalization ---------------------------------------------------
    rate_row_sums = -indexing.diag(rate)  # (B, S)
    base_Z_tmp = torch.gather(rate_row_sums, 1, x_tilde.long())  # (B, D)
    base_Z = base_Z_tmp.sum(1)  # (B,)
    Z_sig_norm = (
        base_Z[:, None, None] - base_Z_tmp[:, :, None] + rate_row_sums[:, None, :]
    )
    sig_norm = torch.sum(
        (outer_rate_sig * outer_qt0_numer_sig * x_tilde_mask)
        / (Z_sig_norm * outer_qt0_denom_sig[:, :, None]),
        dim=(1, 2),
    )

    sig_mean = torch.mean(-outer_sum_sig / sig_norm)
    reg_mean = torch.mean(reg_term)
    return sig_mean + reg_mean


@registry.losses.register
class CTElbo:
    """tauLDR continuous-time ELBO + nll_weight·CE."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.ratio_eps = cfg.loss.eps_ratio
        self.nll_weight = cfg.loss.nll_weight
        self.min_time = cfg.loss.min_time
        self.one_forward_pass = cfg.loss.one_forward_pass
        self.max_t = cfg.training.max_t

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0 = _flatten_batch(minibatch)
        ts = _sample_ts(generator, x0.shape[0], self.min_time, self.max_t)
        neg_elbo, x_logits = _ctelbo_terms(
            model, params, generator, x0, ts, self.ratio_eps,
            self.one_forward_pass, train,
        )
        return neg_elbo + self.nll_weight * mean_cross_entropy(x_logits, x0)


@registry.losses.register
class NLLOriginal:
    """Plain CE of p^θ_{0|t}(x0 | x_t), x_t ~ q_{t|0}."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.max_t = cfg.training.max_t

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0 = _flatten_batch(minibatch)
        ts = _sample_ts(generator, x0.shape[0], self.min_time, self.max_t)
        xt = sample_xt(generator, model.transition(ts), x0)
        # the one loss that conditions on the label (a label-conditional
        # network draws its drop mask from `generator`); the others drop it
        logits = model.apply(params, xt, ts, label=label, train=train, generator=generator)
        return mean_cross_entropy(logits, x0)


@registry.losses.register
class NLL:
    """The CE term of the CTElbo pipeline: x_t and x̃ drawn as CTElbo draws
    them, the network on x_t; the ELBO arithmetic, which JAX also skips, is
    left out."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.max_t = cfg.training.max_t

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0 = _flatten_batch(minibatch)
        ts = _sample_ts(generator, x0.shape[0], self.min_time, self.max_t)
        x_t, _ = sample_xt_xtilde(generator, model.transition(ts), model.rate(ts), x0)
        return mean_cross_entropy(model.apply(params, x_t, ts, train=train), x0)


@registry.losses.register
class CTElboLambda:
    """Iteration-annealed mix w·neg_elbo + (1-w)·CE, w = n_iter/n_iters."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.ratio_eps = cfg.loss.eps_ratio
        self.min_time = cfg.loss.min_time
        self.one_forward_pass = cfg.loss.one_forward_pass
        self.max_t = cfg.training.max_t
        self.n_iters = cfg.training.n_iters

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0 = _flatten_batch(minibatch)
        ts = _sample_ts(generator, x0.shape[0], self.min_time, self.max_t)
        neg_elbo, x_logits = _ctelbo_terms(
            model, params, generator, x0, ts, self.ratio_eps,
            self.one_forward_pass, train,
        )
        w = n_iter / self.n_iters
        return w * neg_elbo + (1.0 - w) * mean_cross_entropy(x_logits, x0)


# ---------------------------------------------------------------------------
# prefix-conditional losses (the first condition_dim dims are clean)
# ---------------------------------------------------------------------------


def _cond_corrupt(model, generator, minibatch, min_time: float, condition_dim: int,
                  ts=None, samples=None):
    """(cond, data, ts, qt0, rate, x_t, x̃): the clean prefix and the suffix
    with its times, tables and draws; `ts` and `samples` (x_t, x̃) may be
    injected, else they are drawn from `generator`."""
    x0_full = _flatten_batch(minibatch)
    cond, data = x0_full[:, :condition_dim], x0_full[:, condition_dim:]
    if ts is None:
        ts = _sample_ts(generator, x0_full.shape[0], min_time, 1.0)
    qt0, rate = model.transition(ts), model.rate(ts)
    x_t, x_tilde = samples if samples is not None else sample_xt_xtilde(
        generator, qt0, rate, data)
    return cond, data, ts, qt0, rate, x_t, x_tilde


@registry.losses.register
class CondCTElbo:
    """CTElbo of the suffix given the clean prefix, + nll_weight·CE; the
    network sees [prefix | x̃] (or [prefix | x_t] without
    `one_forward_pass`) in one pass."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.ratio_eps = cfg.loss.eps_ratio
        self.nll_weight = cfg.loss.nll_weight
        self.min_time = cfg.loss.min_time
        self.one_forward_pass = cfg.loss.one_forward_pass
        self.condition_dim = cfg.loss.condition_dim

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True, ts=None, samples=None):
        """`ts` and `samples` (x_t, x̃) may be injected."""
        cond, data, ts, qt0, rate, x_t, x_tilde = _cond_corrupt(
            model, generator, minibatch, self.min_time, self.condition_dim, ts, samples)
        reg_x = x_tilde if self.one_forward_pass else x_t
        logits_full = model.apply(params, torch.cat([cond, reg_x], dim=1), ts, train=train)
        x_logits = logits_full[:, self.condition_dim:, :]
        p0t = torch.softmax(x_logits, dim=-1)  # the signal term shares the pass
        neg_elbo = _neg_elbo(qt0, rate, data, reg_x, x_tilde, p0t, p0t, self.ratio_eps)
        return neg_elbo + self.nll_weight * mean_cross_entropy(x_logits, data)


@registry.losses.register
class CondNLL:
    """The CE of the suffix logits against the clean suffix, under
    CondCTElbo's corruption and pass. With `loss.aux_key_weight` > 0 (and
    the network's `aux_key_head`) it adds that weight times the CE of the
    key logits at suffix positions against the key inferred from the clean
    prefix (`data.pianoroll.infer_key_torch`)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.one_forward_pass = cfg.loss.one_forward_pass
        self.condition_dim = cfg.loss.condition_dim
        self.aux_key_weight = float(cfg.loss.get("aux_key_weight", 0.0))
        if self.aux_key_weight > 0.0 and not int(cfg.model.get("aux_key_classes", 0)):
            raise ValueError(
                "loss.aux_key_weight > 0 requires model.aux_key_classes > 0 "
                "(the SequenceTransformer aux head)")

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True, ts=None, samples=None):
        """`ts` and `samples` (x_t, x̃) may be injected."""
        cond, data, ts, _, _, x_t, x_tilde = _cond_corrupt(
            model, generator, minibatch, self.min_time, self.condition_dim, ts, samples)
        model_in = torch.cat([cond, x_tilde if self.one_forward_pass else x_t], dim=1)
        if self.aux_key_weight <= 0.0:
            logits_full = model.apply(params, model_in, ts, train=train)
            return mean_cross_entropy(logits_full[:, self.condition_dim:, :], data)
        from ctdd_tpu_torch.data.pianoroll import infer_key_torch

        logits_full, key_logits = model.apply(params, model_in, ts, train=train,
                                              return_aux=True)
        suffix_keys = key_logits[:, self.condition_dim:, :]
        key_label = infer_key_torch(cond)[:, None].expand(suffix_keys.shape[:2])
        return (mean_cross_entropy(logits_full[:, self.condition_dim:, :], data)
                + self.aux_key_weight * mean_cross_entropy(suffix_keys, key_label))


# ---------------------------------------------------------------------------
# SDDM-style ELBO (backward ratios from logprob_with_logits)
# ---------------------------------------------------------------------------


def _sddm_elbo_terms(cfg, model, params, generator, x0, ts, eps, one_forward_pass,
                     train, samples=None):
    """(neg_elbo, logits, ll_all, ll_xt); `samples` optionally injects
    (x_t, x̃), else they are drawn from `generator`."""
    qt0 = model.transition(ts)
    rate = model.rate(ts)
    S = qt0.shape[-1]
    if samples is None:
        x_t, x_tilde = sample_xt_xtilde(generator, qt0, rate, x0)
    else:
        x_t, x_tilde = samples

    reg_x = x_tilde if one_forward_pass else x_t
    logits_reg = model.apply(params, reg_x, ts, train=train)
    reg_tmp = indexing.onehot_mask(reg_x, S) * indexing.cols(rate, reg_x)

    ll_all, ll_xt = logprob_with_logits(cfg.loss.logit_type, model, x_tilde, ts,
                                        logits_reg)
    inner_log_sig = ll_all - ll_xt[..., None]
    reg_term = torch.sum(torch.exp(inner_log_sig) * reg_tmp, dim=(1, 2))

    x_tilde_mask = indexing.onehot_mask(x_tilde, S)
    outer_rate_sig = indexing.cols(rate, x_tilde)
    outer_qt0_numer_sig = indexing.rows(qt0, x0)
    outer_qt0_denom_sig = indexing.elems(qt0, x0, x_tilde) + eps
    outer_sum_sig = torch.sum(
        x_tilde_mask
        * outer_rate_sig
        * (outer_qt0_numer_sig / outer_qt0_denom_sig[:, :, None])
        * inner_log_sig,
        dim=(1, 2),
    )
    rate_row_sums = -indexing.diag(rate)
    base_Z_tmp = torch.gather(rate_row_sums, 1, x_tilde.long())
    base_Z = base_Z_tmp.sum(1)
    Z_sig_norm = (
        base_Z[:, None, None] - base_Z_tmp[:, :, None] + rate_row_sums[:, None, :]
    )
    sig_norm = torch.sum(
        (outer_rate_sig * x_tilde_mask * outer_qt0_numer_sig)
        / (Z_sig_norm * outer_qt0_denom_sig[:, :, None]),
        dim=(1, 2),
    )
    neg_elbo = torch.mean(-outer_sum_sig / sig_norm) + torch.mean(reg_term)
    return neg_elbo, logits_reg, ll_all, ll_xt


class _SDDMBase:
    def __init__(self, cfg):
        self.cfg = cfg
        self.ratio_eps = cfg.loss.eps_ratio
        self.nll_weight = cfg.loss.nll_weight
        self.min_time = cfg.loss.min_time
        self.one_forward_pass = cfg.loss.one_forward_pass

    def _terms(self, model, params, generator, minibatch, label, train):
        x0 = _flatten_batch(minibatch)
        ts = _sample_ts(generator, x0.shape[0], self.min_time, 1.0, clamp_hi=0.99999)
        return x0, _sddm_elbo_terms(self.cfg, model, params, generator, x0, ts,
                                    self.ratio_eps, self.one_forward_pass, train)


@registry.losses.register
class SDDMElbo(_SDDMBase):
    """CT-ELBO with SDDM backward ratios + nll_weight·CE."""

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0, (neg_elbo, logits, _, _) = self._terms(model, params, generator, minibatch,
                                                   label, train)
        return neg_elbo + self.nll_weight * mean_cross_entropy(logits, x0)


@registry.losses.register
class ScoreElbo(_SDDMBase):
    """SDDMElbo + nll_weight · the ratio-matching aux, -Σ ll_xt / B."""

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0, (neg_elbo, _, _, ll_xt) = self._terms(model, params, generator, minibatch,
                                                  label, train)
        return neg_elbo + self.nll_weight * torch.sum(-ll_xt) / x0.shape[0]


# ---------------------------------------------------------------------------
# Categorical ratio matching family
# ---------------------------------------------------------------------------


def _catrm_comp_loss(cfg, model, xt, t, ll_all, ll_xt):
    """Per-dimension loss of the rm / mle / elbo variants, (B, D)."""
    S = cfg.data.S
    loss_type = cfg.loss.loss_type
    if loss_type == "rm":
        return -ll_xt
    if loss_type == "mle":
        return -((S - 1) * ll_xt + torch.sum(log1mexp(ll_all), dim=-1) - log1mexp(ll_xt))
    if loss_type == "elbo":
        not_xt = indexing.onehot_mask(xt, S)
        qt0_x2y = model.transition(t)  # (B, S, S)
        ll_xt_e = ll_xt[..., None]
        backwd = torch.exp(ll_all - ll_xt_e) * indexing.cols(qt0_x2y, xt)
        fwd = (ll_xt_e - ll_all) * indexing.rows(qt0_x2y, xt)
        return torch.sum(backwd * not_xt, dim=-1) - torch.sum(fwd * not_xt, dim=-1)
    raise ValueError(f"unknown loss_type {loss_type}")


class _CatRMBase:
    def __init__(self, cfg, max_t: float, clamp_hi: Optional[float]):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.max_t, self.clamp_hi = max_t, clamp_hi

    def _terms(self, model, params, generator, minibatch, label, train):
        """(x0, logits, the summed ratio-matching loss over B)."""
        x0 = _flatten_batch(minibatch)
        B = x0.shape[0]
        ts = _sample_ts(generator, B, self.min_time, self.max_t, clamp_hi=self.clamp_hi)
        xt = sample_xt(generator, model.transition(ts), x0)
        logits = model.apply(params, xt, ts, train=train)
        ll_all, ll_xt = logprob_with_logits(self.cfg.loss.logit_type, model, xt, ts,
                                            logits)
        loss = _catrm_comp_loss(self.cfg, model, xt, ts, ll_all, ll_xt)
        return x0, logits, torch.sum(loss * (1.0 - self.cfg.loss.ce_coeff)) / B


@registry.losses.register
class CatRM(_CatRMBase):
    """SDDM categorical ratio matching (times in [min_time, 1), clamped
    below 1)."""

    def __init__(self, cfg):
        super().__init__(cfg, max_t=1.0, clamp_hi=0.99999)

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        return self._terms(model, params, generator, minibatch, label, train)[2]


@registry.losses.register
class CatRMNLL(_CatRMBase):
    """CatRM (times up to training.max_t, unclamped) + nll_weight·CE."""

    def __init__(self, cfg):
        super().__init__(cfg, max_t=cfg.training.max_t, clamp_hi=None)
        self.nll_weight = cfg.loss.nll_weight

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0, logits, rm = self._terms(model, params, generator, minibatch, label, train)
        return rm + self.nll_weight * mean_cross_entropy(logits, x0)



# ---------------------------------------------------------------------------
# energy-based models (the network returns one energy per row)
# ---------------------------------------------------------------------------


def ebm_all_mutation_logits(model, params, xt, ts, S: int, train: bool = False):
    """(B, D, S) logits: logits[b, d, s] is the energy of xt[b] with dim d
    set to s; one forward over the D·S·B mutated rows."""
    B, D = xt.shape
    mask = torch.eye(D, dtype=xt.dtype, device=xt.device)  # (D, D)
    cand = torch.arange(S, dtype=xt.dtype, device=xt.device)
    # xall[d, s, b] = xt[b] with dim d replaced by s
    xall = (mask[:, None, None, :] * cand[None, :, None, None]
            + (1 - mask)[:, None, None, :] * xt[None, None, :, :])  # (D, S, B, D)
    t_all = ts[None, None, :].expand(D, S, B).reshape(-1)
    energies = model.apply(params, xall.reshape(D * S * B, D), t_all, train=train)
    return energies.reshape(D, S, B).permute(2, 0, 1)


def bin_ebm_flip_logits(model, params, xt, ts, train: bool = False):
    """Binary EBM logits (B, D, 2): the energy of xt[b] at s == xt[b, d],
    else that of xt[b] with bit d flipped; one forward over the (D+1)·B rows
    [xt | its D single-bit flips]."""
    B, D = xt.shape
    mask = torch.eye(D, dtype=xt.dtype, device=xt.device)[:, None, :]  # (D, 1, D)
    # xneg[d, b] = xt[b] with bit d flipped (states {0, 1})
    xneg = (mask - xt[None]) * mask + (1 - mask) * xt[None]  # (D, B, D)
    rows = torch.cat([xt, xneg.reshape(D * B, D)], dim=0)
    t_all = ts[None, :].expand(D + 1, B).reshape(-1)
    energies = model.apply(params, rows, t_all, train=train)
    qxt, qxneg = energies[:B], energies[B:].reshape(D, B).t()  # (B,), (B, D)
    xt_onehot = torch.nn.functional.one_hot(xt.long(), 2).to(energies.dtype)
    return xt_onehot * qxt[:, None, None] + (1.0 - xt_onehot) * qxneg[..., None]


def _ebm_draws(model, generator, x0, min_time: float, ts=None, samples=None):
    """(ts, x_t) of the EBM losses, times clamped below 1; either may be
    injected."""
    if ts is None:
        ts = _sample_ts(generator, x0.shape[0], min_time, 1.0, clamp_hi=0.99999)
    if samples is None:
        return ts, sample_xt(generator, model.transition(ts), x0)
    return ts, samples[0]


@registry.losses.register
class EBMAux:
    """Energy-based ratio matching over all D·S single-site mutations:
    -Σ_d log softmax_s(logits)[x_t] averaged over the batch."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.S = cfg.data.S

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True, ts=None, samples=None):
        """`ts` and `samples` (x_t,) may be injected."""
        x0 = _flatten_batch(minibatch)
        ts, xt = _ebm_draws(model, generator, x0, self.min_time, ts, samples)
        logits = ebm_all_mutation_logits(model, params, xt, ts, self.S, train=train)
        ll_xt = torch.gather(torch.log_softmax(logits, dim=-1), -1, xt.long()[..., None])
        return torch.mean(-torch.sum(ll_xt[..., 0], dim=-1))


@registry.losses.register
class BinEBMAux:
    """Binary EBM ratio matching over the D single-bit flips: -Σ ll_xt / B
    under `loss.logit_type`."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True, ts=None, samples=None):
        """`ts` and `samples` (x_t,) may be injected."""
        x0 = _flatten_batch(minibatch)
        ts, xt = _ebm_draws(model, generator, x0, self.min_time, ts, samples)
        logits = bin_ebm_flip_logits(model, params, xt, ts, train=train)
        _, ll_xt = logprob_with_logits(self.cfg.loss.logit_type, model, xt, ts, logits)
        return torch.sum(-ll_xt) / x0.shape[0]


# ---------------------------------------------------------------------------
# block diffusion with the absorbing process
# ---------------------------------------------------------------------------


def block_absorbing_terms(model, params, generator, x0: torch.Tensor, min_time: float,
                          block: int, train: bool = True):
    """(B,) terms of the block-diffusion CT-ELBO and the network's logits.

    Per row, one t per block of `block` tokens, uniform in [min_time, 1)
    (one (B, L / block) draw), then x_t from the process's one draw a
    position; the network sees x_t ⊕ x0 and gives the noisy half's logits.
    A row's term is (1/L) Σ_i 1[x_t,i = mask] · w(t_b(i)) · CE_i, with w the
    process's ELBO weight (1/t on the linear schedule) and CE_i the cross
    entropy of x0_i under the logits with the mask id's left out of the
    softmax (MDLM's SUBS parameterisation, arXiv:2406.07524)."""
    proc = model.process
    B, L = x0.shape
    if L % block:
        raise ValueError(f"the sequence length {L} is not a multiple of the block {block}")
    t = torch.rand((B, L // block), generator=generator, device=x0.device)
    t = (t * (1.0 - min_time) + min_time).repeat_interleave(block, dim=1)
    x_t = proc.corrupt(generator, x0, t)
    logits = model.apply(params, torch.cat([x_t, x0], dim=1), t, train=train)
    subs = torch.arange(logits.shape[-1], device=x0.device) == proc.mask_id
    ce = F.cross_entropy(logits.masked_fill(subs, float("-inf")).flatten(0, 1),
                         x0.reshape(-1).long(), reduction="none").view(B, L)
    masked = (x_t == proc.mask_id).float()
    return (masked * proc.elbo_weight(t) * ce).sum(1) / L, logits


@registry.losses.register
class BlockAbsorbingElbo:
    """The block-diffusion CT-ELBO of the absorbing process (BD3-LM's
    vectorised training): a time-weighted cross entropy over the masked
    positions, a t per block; the mean of `block_absorbing_terms`."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.min_time = cfg.loss.min_time
        self.block = int(cfg.model.block_length)

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True):
        x0 = _flatten_batch(minibatch)
        terms, _ = block_absorbing_terms(model, params, generator, x0, self.min_time,
                                         self.block, train)
        return terms.mean()
