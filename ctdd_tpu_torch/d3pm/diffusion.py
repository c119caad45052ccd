"""D3PM discrete-time categorical diffusion baseline.

Counterpart of ctdd_tpu/d3pm/diffusion.py: beta schedules, the one-step
Q_t matrices (uniform band, gaussian band, absorbing), the cumulative
products, q_sample by the Gumbel trick, the posterior logits, the x_start
parameterized p_logits, ancestral sampling and the kl /
cross_entropy_x_start / hybrid losses with calc_bpd_loop.

The tables are built on the host in float64 with the JAX package's numpy
arithmetic (the one-step matrices vectorized, which leaves every entry and
every row sum as it was; the cumulative product one step at a time), cast to
float32 and moved once to the diffusion's device; the transposed one-step
table is a view. Differences from the JAX package, none of which changes a
value or a gradient:

- `_at` (a[t][x]) is an exact gather where JAX multiplies by a one-hot
  matrix (also exact in float32); `_at_onehot` is a float32 batched product
  with TF32 off.
- Randomness comes from a `torch.Generator`. Every stochastic function also
  takes its noise (t, the Gumbel noise, the uniforms) as an optional
  argument, so that a test can drive it with the JAX package's draws.
- `p_sample_loop` is a Python loop over t = T-1 ... 0 (JAX: `lax.scan`).
- The `hybrid` loss returns the cross-entropy alone, as JAX (and the
  reference) do, without computing the vb term it discards.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.special
import torch
import torch.nn.functional as F

from ctdd_tpu_torch.d3pm import utils as d3pm_utils
from ctdd_tpu_torch.utils.device import resolve_device, tf32_off

TINY = float(np.finfo(np.float32).tiny)


def get_diffusion_betas(spec) -> np.ndarray:
    """beta_t schedules: linear / cosine / jsd."""
    T = spec.num_timesteps
    if spec.type == "linear":
        return np.linspace(spec.start, spec.stop, T)
    if spec.type == "cosine":
        steps = np.arange(T + 1, dtype=np.float64) / T
        alpha_bar = np.cos((steps + 0.008) / 1.008 * np.pi / 2)
        return np.minimum(1 - alpha_bar[1:] / alpha_bar[:-1], 0.999)
    if spec.type == "jsd":
        return 1.0 / np.linspace(T, 1.0, T)
    raise NotImplementedError(spec.type)


def _banded(values: np.ndarray, S: int) -> np.ndarray:
    """(T, S, S) matrices with values[t, |i - j|] off the diagonal (values[t, 0]
    is unused; distances past the last value are 0) and each row summing to 1
    on the diagonal. Each off-diagonal entry and each row sum equals what the
    JAX package's sum of np.diag bands gives: the gather returns an array
    whose fastest axis is T, so it is copied C-contiguous first, and each
    row is then summed along contiguous memory (pairwise, as JAX's
    `mat.sum(1)` of one matrix; along the strided axis numpy adds
    sequentially, which moved ~2e5 of mnist_d3pm's diagonal entries by up
    to 3.5e-14 relative)."""
    T, n = values.shape
    dist = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :])
    padded = np.concatenate([np.zeros((T, 1)), values[:, 1:], np.zeros((T, 1))], axis=1)
    mats = np.ascontiguousarray(padded[:, np.minimum(dist, n)])
    diag = 1.0 - mats.sum(2)
    idx = np.arange(S)
    mats[:, idx, idx] = diag
    return mats


def _uniform_band_mats(betas: np.ndarray, S: int, bands: Optional[int]) -> np.ndarray:
    if bands is None:
        mats = np.broadcast_to((betas / S)[:, None, None], (len(betas), S, S)).copy()
        idx = np.arange(S)
        mats[:, idx, idx] = (1.0 - betas * (S - 1.0) / S)[:, None]
        return mats
    values = np.repeat((betas / S)[:, None], bands + 1, axis=1)
    return _banded(values, S)


def _gaussian_band_values(beta_t: float, S: int, tb: int) -> np.ndarray:
    values = np.linspace(0.0, 255.0, S, dtype=np.float64)
    values = values * 2.0 / (S - 1.0)
    values = values[: tb + 1]
    values = -values * values / beta_t
    values = np.concatenate([values[:0:-1], values])
    values = scipy.special.softmax(values, axis=0)
    return values[tb:]


def _gaussian_band_mats(betas: np.ndarray, S: int, bands: Optional[int]) -> np.ndarray:
    tb = bands if bands else S - 1
    return _banded(np.stack([_gaussian_band_values(b, S, tb) for b in betas]), S)


def _absorbing_mats(betas: np.ndarray, S: int) -> np.ndarray:
    """Absorbing state at S // 2."""
    mats = np.zeros((len(betas), S, S), np.float64)
    idx = np.arange(S)
    mats[:, idx, idx] = (1.0 - betas)[:, None]
    mats[:, :, S // 2] += betas[:, None]
    return mats


def _uniform_band_mat(beta_t: float, S: int, bands: Optional[int]) -> np.ndarray:
    return _uniform_band_mats(np.asarray([beta_t], np.float64), S, bands)[0]


def _gaussian_band_mat(beta_t: float, S: int, bands: Optional[int]) -> np.ndarray:
    return _gaussian_band_mats(np.asarray([beta_t], np.float64), S, bands)[0]


def _absorbing_mat(beta_t: float, S: int) -> np.ndarray:
    return _absorbing_mats(np.asarray([beta_t], np.float64), S)[0]


@functools.lru_cache(maxsize=4)
def _host_tables(betas: bytes, kind: str, bands: Optional[int], S: int):
    """(one-step, cumulative) float32 tables of `betas` (float64 bytes). The
    cumulative product runs one float64 (S, S) product a step over
    C-contiguous slices (on the strided layout `_banded` once returned,
    mnist_d3pm's 1000 steps took 171 s on a loaded CPU, against 3.2 s
    contiguous). A process that builds one configuration again (a second
    train run, an eval) reuses the tables; the caller must not write to
    them."""
    b = np.frombuffer(betas, np.float64)
    if kind == "uniform":
        q_onestep = _uniform_band_mats(b, S, bands)
    elif kind == "gaussian":
        q_onestep = _gaussian_band_mats(b, S, bands)
    elif kind == "absorbing":
        q_onestep = _absorbing_mats(b, S)
    else:
        raise ValueError(kind)
    q_onestep = np.ascontiguousarray(q_onestep)  # each q_onestep[t] one block
    q_mats = np.empty_like(q_onestep)
    q_mats[0] = q_onestep[0]
    for t in range(1, len(b)):
        q_mats[t] = q_mats[t - 1] @ q_onestep[t]
    return q_onestep.astype(np.float32), q_mats.astype(np.float32)


def _gumbel(shape, generator, device) -> torch.Tensor:
    """-log(-log u), u uniform in [tiny, 1) (JAX's `jax.random.gumbel`)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min_(TINY)
    return -torch.log(-torch.log(u))


class CategoricalDiffusion:
    """Discrete-time categorical diffusion on `device` (the GPU unless the
    caller passes another)."""

    def __init__(self, betas, model_prediction: str, model_output: str,
                 transition_mat_type: str, transition_bands: Optional[int],
                 loss_type: str, hybrid_coeff: float, num_pixel_vals: int,
                 eps: float = 1e-6, device=None):
        self.model_prediction = model_prediction  # 'x_start' (xprev unimplemented)
        self.model_output = model_output  # 'logits' | 'logistic_pars'
        self.transition_mat_type = transition_mat_type
        self.transition_bands = transition_bands
        self.loss_type = loss_type  # 'kl' | 'hybrid' | 'cross_entropy_x_start'
        self.hybrid_coeff = hybrid_coeff
        self.num_pixel_vals = num_pixel_vals
        self.eps = eps
        self.device = resolve_device(device)
        betas = np.asarray(betas, np.float64)
        if not ((betas > 0) & (betas <= 1)).all():
            raise ValueError("betas must be in (0, 1]")
        self.betas = betas
        self.num_timesteps = len(betas)
        q_onestep, q_mats = _host_tables(betas.tobytes(), transition_mat_type,
                                         transition_bands, num_pixel_vals)
        self.q_onestep_mats = torch.from_numpy(q_onestep).to(self.device)
        self.q_mats = torch.from_numpy(q_mats).to(self.device)
        self.transpose_q_onestep_mats = self.q_onestep_mats.transpose(1, 2)

    # -- gathers ------------------------------------------------------------
    def _at(self, a, t, x):
        """a[t][x] -> (B, ..., S), an exact gather."""
        t_b = t.reshape((t.shape[0],) + (1,) * (x.dim() - 1)).long()
        return a[t_b, x.long()]

    def _at_onehot(self, a, t, x):
        """x (B, ..., S) times a[t], without TF32 (float32 tables and x)."""
        shape = x.shape
        with tf32_off():
            out = torch.bmm(x.reshape(shape[0], -1, self.num_pixel_vals), a[t.long()])
        return out.reshape(shape)

    # -- forward process -----------------------------------------------------
    def q_probs(self, x_start, t):
        """q(x_t | x_start) probabilities."""
        return self._at(self.q_mats, t, x_start)

    def q_sample(self, x_start, t, generator=None, gumbel=None):
        """A sample of q(x_t | x_start) by the Gumbel trick; `gumbel` (the
        probabilities' shape) is drawn from `generator` when not given."""
        logits = torch.log(self.q_probs(x_start, t) + self.eps)
        if gumbel is None:
            gumbel = _gumbel(logits.shape, generator, logits.device)
        return torch.argmax(logits + gumbel, dim=-1)

    def _get_logits_from_logistic_pars(self, loc, log_scale):
        """Bin width 2/(S-1) and centers spanning [-1, 1]: the D3PM
        convention, distinct from the CTMC logistic head."""
        loc = loc[..., None]
        log_scale = log_scale[..., None]
        inv_scale = torch.exp(-(log_scale - 2.0))
        S = self.num_pixel_vals
        bin_width = 2.0 / (S - 1.0)
        bin_centers = torch.linspace(-1.0, 1.0, S, device=loc.device)
        bin_centers = bin_centers.reshape((1,) * (loc.dim() - 1) + (S,)) - loc
        log_cdf_min = F.logsigmoid(inv_scale * (bin_centers - 0.5 * bin_width))
        log_cdf_plus = F.logsigmoid(inv_scale * (bin_centers + 0.5 * bin_width))
        return d3pm_utils.log_min_exp(log_cdf_plus, log_cdf_min, self.eps)

    # -- reverse process -----------------------------------------------------
    def q_posterior_logits(self, x_start, x_t, t, x_start_logits: bool):
        """Logits of q(x_{t-1} | x_t, x_start)."""
        fact1 = self._at(self.transpose_q_onestep_mats, t, x_t)
        t_1 = torch.where(t == 0, t, t - 1)
        if x_start_logits:
            fact2 = self._at_onehot(self.q_mats, t_1, F.softmax(x_start, dim=-1))
            tzero_logits = x_start
        else:
            fact2 = self._at(self.q_mats, t_1, x_start)
            tzero_logits = torch.log(
                F.one_hot(x_start.long(), self.num_pixel_vals).to(fact1.dtype) + self.eps)
        out = torch.log(fact1 + self.eps) + torch.log(fact2 + self.eps)
        t_b = t.reshape((t.shape[0],) + (1,) * (out.dim() - 1))
        return torch.where(t_b == 0, tzero_logits, out)

    def p_logits(self, model_fn: Callable, x, t):
        """Logits of p(x_{t-1} | x_t) and the predicted x_start logits."""
        model_output = model_fn(x, t)
        if self.model_output == "logits":
            model_logits = model_output
        elif self.model_output == "logistic_pars":
            model_logits = self._get_logits_from_logistic_pars(*model_output)
        else:
            raise NotImplementedError(self.model_output)
        if self.model_prediction != "x_start":
            raise NotImplementedError(self.model_prediction)
        pred_x_start_logits = model_logits
        t_b = t.reshape((t.shape[0],) + (1,) * (model_logits.dim() - 1))
        model_logits = torch.where(
            t_b == 0, pred_x_start_logits,
            self.q_posterior_logits(pred_x_start_logits, x, t, x_start_logits=True))
        return model_logits, pred_x_start_logits

    # -- sampling ------------------------------------------------------------
    def p_sample(self, model_fn, x, t, generator=None, u=None):
        """One ancestral step, no noise where t == 0. `u` (the logits'
        shape, in [tiny, 1)) is drawn from `generator` when not given.
        Returns (sample, softmax of the predicted x_start logits)."""
        model_logits, pred_x_start_logits = self.p_logits(model_fn, x, t)
        nonzero = (t != 0).reshape((x.shape[0],) + (1,) * x.dim()).to(model_logits.dtype)
        if u is None:
            gumbel = _gumbel(model_logits.shape, generator, model_logits.device)
        else:
            gumbel = -torch.log(-torch.log(u.to(model_logits.device)))
        sample = torch.argmax(model_logits + nonzero * gumbel, dim=-1)
        return sample, F.softmax(pred_x_start_logits, dim=-1)

    def initial_states(self, shape, generator=None) -> torch.Tensor:
        """x_T: uniform states (gaussian, uniform) or all S // 2 (absorbing)."""
        if self.transition_mat_type in ("gaussian", "uniform"):
            return torch.randint(0, self.num_pixel_vals, shape, generator=generator,
                                 device=self.device)
        if self.transition_mat_type == "absorbing":
            return torch.full(shape, self.num_pixel_vals // 2, dtype=torch.long,
                              device=self.device)
        raise ValueError(self.transition_mat_type)

    @torch.no_grad()
    def p_sample_loop(self, model_fn, shape, generator=None, x_init=None,
                      uniforms: Optional[Sequence[torch.Tensor]] = None):
        """Ancestral sampling over t = T-1 ... 0, one `p_sample` a step.
        `x_init` and `uniforms` (one tensor a step, in the loop's order)
        are drawn from `generator` when not given."""
        x = self.initial_states(shape, generator) if x_init is None else x_init.to(self.device)
        for i, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), ti, dtype=torch.long, device=self.device)
            x, _ = self.p_sample(model_fn, x, t, generator,
                                 None if uniforms is None else uniforms[i])
        return x

    # -- losses ----------------------------------------------------------------
    def vb_terms_bpd(self, model_fn, x_start, x_t, t):
        true_logits = self.q_posterior_logits(x_start, x_t, t, x_start_logits=False)
        model_logits, pred_x_start_logits = self.p_logits(model_fn, x_t, t)
        kl = d3pm_utils.categorical_kl_logits(true_logits, model_logits)
        kl = d3pm_utils.meanflat(kl) / math.log(2.0)
        decoder_nll = -d3pm_utils.categorical_log_likelihood(x_start, model_logits)
        decoder_nll = d3pm_utils.meanflat(decoder_nll) / math.log(2.0)
        return torch.where(t == 0, decoder_nll, kl), pred_x_start_logits

    def prior_bpd(self, x_start):
        T = self.num_timesteps
        t = torch.full((x_start.shape[0],), T - 1, dtype=torch.long, device=x_start.device)
        q_probs = self.q_probs(x_start, t)
        if self.transition_mat_type in ("gaussian", "uniform"):
            prior = torch.ones_like(q_probs) / self.num_pixel_vals
        else:
            prior = torch.zeros_like(q_probs)
            prior[..., self.num_pixel_vals // 2] = 1.0
        kl = d3pm_utils.categorical_kl_probs(q_probs, prior)
        return d3pm_utils.meanflat(kl) / math.log(2.0)

    def cross_entropy_x_start(self, x_start, pred_x_start_logits):
        ce = -d3pm_utils.categorical_log_likelihood(x_start, pred_x_start_logits)
        return d3pm_utils.meanflat(ce) / math.log(2.0)

    def training_losses(self, model_fn, x_start, t, generator=None, gumbel=None):
        """Per-example losses; x_t drawn by `q_sample` (its Gumbel noise from
        `generator` unless `gumbel` is given). 'hybrid' is the cross-entropy
        alone, as in the JAX package (whose vb term is computed and dropped)."""
        x_t = self.q_sample(x_start, t, generator, gumbel)
        if self.loss_type == "kl":
            losses, _ = self.vb_terms_bpd(model_fn, x_start, x_t, t)
        elif self.loss_type in ("cross_entropy_x_start", "hybrid"):
            _, pred_x_start_logits = self.p_logits(model_fn, x_t, t)
            losses = self.cross_entropy_x_start(x_start, pred_x_start_logits)
        else:
            raise NotImplementedError(self.loss_type)
        return losses

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn, x_start, generator=None,
                      gumbels: Optional[Sequence[torch.Tensor]] = None):
        """The full variational bound over t = T-1 ... 0; `gumbels` holds
        each step's q_sample noise in that order (drawn when not given)."""
        B = x_start.shape[0]
        vbterms = []
        for i, ti in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t_b = torch.full((B,), ti, dtype=torch.long, device=x_start.device)
            x_t = self.q_sample(x_start, t_b, generator,
                                None if gumbels is None else gumbels[i])
            vbterms.append(self.vb_terms_bpd(model_fn, x_start, x_t, t_b)[0])
        vbterms = torch.stack(vbterms)  # (T, B)
        prior_b = self.prior_bpd(x_start)
        return {"total": vbterms.sum(dim=0) + prior_b, "vbterms": vbterms.T,
                "prior": prior_b}


def make_diffusion(model_cfg, device=None) -> CategoricalDiffusion:
    """Build from cfg.model on `device`."""
    return CategoricalDiffusion(
        betas=get_diffusion_betas(model_cfg),
        model_prediction=model_cfg.model_prediction,
        model_output=model_cfg.model_output,
        transition_mat_type=model_cfg.transition_mat_type,
        transition_bands=model_cfg.transition_bands,
        loss_type=model_cfg.loss_type,
        hybrid_coeff=model_cfg.hybrid_coeff,
        num_pixel_vals=model_cfg.num_pixel_vals,
        device=device,
    )


class D3PMLoss:
    """Uniform integer t, the mean of `training_losses`. Built from the
    diffusion, as the train loop does (the CTMC losses come from the loss
    registry)."""

    def __init__(self, cfg, diffusion: CategoricalDiffusion):
        self.cfg = cfg
        self.diffusion = diffusion
        self.num_timesteps = cfg.model.num_timesteps

    def calc_loss(self, model, params, generator, minibatch, label=None, n_iter=0,
                  train=True, t=None, gumbel=None):
        """`t` and `gumbel` are drawn from `generator` when not given."""
        B = minibatch.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (B,), generator=generator,
                              device=minibatch.device)

        def model_fn(x, ti):
            return model.apply(params, x, ti, train=train)

        return self.diffusion.training_losses(model_fn, minibatch, t, generator,
                                              gumbel).mean()
