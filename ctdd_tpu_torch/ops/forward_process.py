"""CTMC forward processes: rate and spectral transition kernels.

Counterpart of ctdd_tpu/ops/forward_process.py. Each process holds the
host-computed eigendecomposition of its base rate matrix as float32 tensors
on one device; `rate` / `transition` / `transit_between` / `rate_mat` are
tensor functions of a (B,) time tensor.

Eigendecompositions are done once on host in float64 with numpy and cast to
float32. All processes share the spectral-propagator form
    q_{t2|t1} = V · exp(Λ · ∫_{t1}^{t2} β) · V⁻¹
with per-kind β(t) schedules; the kinds differ in the base matrix and in
whether rows are renormalized before the 1e-8 zero-clamp (all kinds except
plain UniformRate renormalize).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.ops import indexing

SCHEDULE_CONST = "const"
SCHEDULE_BD_EXP = "bd_exp"  # birth-death σ_min/σ_max exponential
SCHEDULE_LOG_SQR = "log_sqr"
SCHEDULE_SQRT_COS = "sqrt_cos"
SCHEDULE_LOG = "log"  # time_base · time_exp^t family (GaussianTargetRate too)


def _beta(kind: str, p: Tuple[float, ...], t: torch.Tensor) -> torch.Tensor:
    """β(t): the instantaneous rate scalar."""
    if kind == SCHEDULE_CONST:
        return torch.ones_like(t)
    if kind == SCHEDULE_BD_EXP:
        sig_min, sig_max = p
        return (
            sig_min**2
            * torch.pow(sig_max / sig_min, 2.0 * t)
            * math.log(sig_max / sig_min)
        )
    if kind == SCHEDULE_LOG_SQR:
        return 2.0 * t / (t**2 + 1.0)
    if kind == SCHEDULE_SQRT_COS:
        th = math.pi / 2.0 * t
        return math.pi / 4.0 * torch.sin(th) / torch.sqrt(torch.cos(th))
    if kind == SCHEDULE_LOG:
        time_base, time_exp = p
        return time_base * math.log(time_exp) * torch.pow(time_exp, t)
    raise ValueError(f"unknown schedule {kind}")


def _beta_integral(kind: str, p: Tuple[float, ...], t: torch.Tensor) -> torch.Tensor:
    """∫₀ᵗ β up to a constant (only differences are used)."""
    if kind == SCHEDULE_CONST:
        return t
    if kind == SCHEDULE_BD_EXP:
        sig_min, sig_max = p
        return (0.5 * sig_min**2 * torch.pow(sig_max / sig_min, 2.0 * t)
                - 0.5 * sig_min**2)
    if kind == SCHEDULE_LOG_SQR:
        return torch.log(t**2 + 1.0)
    if kind == SCHEDULE_SQRT_COS:
        return -torch.sqrt(torch.cos(math.pi / 2.0 * t))
    if kind == SCHEDULE_LOG:
        time_base, time_exp = p
        return time_base * torch.pow(time_exp, t) - time_base
    raise ValueError(f"unknown schedule {kind}")


class ForwardProcess:
    """A CTMC with rate R_t = β(t)·R_base and spectral transition kernels."""

    def __init__(
        self, base_rate, eigvals, eigvecs, inv_eigvecs, *, kind: str,
        schedule: str, schedule_params: Tuple[float, ...] = (),
        renormalize: bool = True, clamp: float = 1e-8, device="cpu",
    ):
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.base_rate = f32(base_rate)  # (S, S), negative diagonal
        self.eigvals = f32(eigvals)  # (S,)
        self.eigvecs = f32(eigvecs)  # (S, S)
        self.inv_eigvecs = f32(inv_eigvecs)  # (S, S); Vᵀ when symmetric
        self.kind = kind
        self.schedule = schedule
        self.schedule_params = tuple(schedule_params)
        self.renormalize = renormalize
        self.clamp = clamp

    @property
    def S(self) -> int:
        return self.base_rate.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.base_rate.device

    # -- rate ---------------------------------------------------------------
    def rate(self, t: torch.Tensor) -> torch.Tensor:
        """R_t, shape (B, S, S)."""
        beta = _beta(self.schedule, self.schedule_params, t)
        return self.base_rate[None, :, :] * beta[:, None, None]

    def rate_mat(self, y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """R_t[y] rows, shape (B, D, S)."""
        return indexing.rows(self.rate(t), y)

    # -- transition kernels ---------------------------------------------------
    def _propagate(self, w: torch.Tensor) -> torch.Tensor:
        """V · diag(exp(w)) · V⁻¹ for per-batch eigen-weights w (B, S).

        A float32 matmul: on CUDA this relies on PyTorch's default of TF32
        off for matmuls (`torch.backends.cuda.matmul.allow_tf32`); entries
        near the 1e-8 clamp need the full mantissa."""
        scaled = self.eigvecs[None, :, :] * torch.exp(w)[:, None, :]
        trans = torch.matmul(scaled, self.inv_eigvecs)
        if self.renormalize:
            trans = trans / torch.sum(trans, dim=-1, keepdim=True)
        return torch.where(trans < self.clamp, torch.zeros_like(trans), trans)

    def transition(self, t: torch.Tensor) -> torch.Tensor:
        """q_{t|0}, shape (B, S, S)."""
        zero = torch.zeros_like(t)
        integ = (_beta_integral(self.schedule, self.schedule_params, t)
                 - _beta_integral(self.schedule, self.schedule_params, zero))
        return self._propagate(integ[:, None] * self.eigvals[None, :])

    def transit_between(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        """q_{t2|t1}, shape (B, S, S); uses the true V⁻¹ for every kind."""
        d = (_beta_integral(self.schedule, self.schedule_params, t2)
             - _beta_integral(self.schedule, self.schedule_params, t1))
        return self._propagate(d[:, None] * self.eigvals[None, :])


# ---------------------------------------------------------------------------
# Host-side constructors (numpy, float64, once at init)
# ---------------------------------------------------------------------------


def _symmetric(base_rate: np.ndarray):
    eigvals, eigvecs = np.linalg.eigh(base_rate)
    return eigvals, eigvecs, eigvecs.T.copy()


def birth_death_base_rate(S: int) -> np.ndarray:
    """Tridiagonal birth-death R_b."""
    r = np.diag(np.ones(S - 1), 1) + np.diag(np.ones(S - 1), -1)
    return r - np.diag(r.sum(axis=1))


def uniform_base_rate(S: int, rate_const: float) -> np.ndarray:
    """Uniform R = c·(𝟙 - S·I)."""
    r = rate_const * np.ones((S, S))
    r -= np.diag(np.diag(r))
    return r - np.diag(r.sum(axis=1))


def gaussian_target_base_rate(S: int, rate_sigma: float, Q_sigma: float) -> np.ndarray:
    """Banded Gaussian rate matrix with detailed-balance transposes.

    Upper-triangular band entries decay as exp(-(j-i-1)²/σ_r²) within
    |i - S/2|-dependent bands; entries below the diagonal are filled by the
    detailed-balance factor exp(-((j+1)² - (i+1)² + S(i+1) - S(j+1)) / (2σ_Q²)).
    """
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    vals = np.exp(-np.arange(S) ** 2 / rate_sigma**2)
    upper = (i < S // 2) & (j > i) & (j < S - i)
    lower = (i > S // 2) & (j < i) & (j > S - i - 1)
    band = np.where(j > i, j - i - 1, i - j - 1)
    rate = np.where(upper | lower, vals[np.clip(band, 0, S - 1)], 0.0)
    db = rate.T * np.exp(
        -((j + 1.0) ** 2 - (i + 1.0) ** 2 + S * (i + 1.0) - S * (j + 1.0))
        / (2.0 * Q_sigma**2)
    )
    rate = np.where(rate.T > 0.0, db, rate)
    rate -= np.diag(np.diag(rate))
    return rate - np.diag(rate.sum(axis=1))


@registry.processes.register(name="BirthDeathForwardBase")
def make_birth_death(S: int, sigma_min: float, sigma_max: float,
                     device="cpu") -> ForwardProcess:
    base = birth_death_base_rate(S)
    ev, V, Vi = _symmetric(base)
    return ForwardProcess(
        base, ev, V, Vi, kind="birth_death", schedule=SCHEDULE_BD_EXP,
        schedule_params=(float(sigma_min), float(sigma_max)),
        renormalize=True, device=device,
    )


@registry.processes.register(name="UniformRate")
def make_uniform(S: int, rate_const: float, device="cpu") -> ForwardProcess:
    base = uniform_base_rate(S, rate_const)
    ev, V, Vi = _symmetric(base)
    return ForwardProcess(
        base, ev, V, Vi, kind="uniform", schedule=SCHEDULE_CONST,
        renormalize=False,  # plain UniformRate does not renormalize
        device=device,
    )


@registry.processes.register(name="UniformVariantRate")
def make_uniform_variant(
    S: int, rate_const: float, t_func: str, time_base: float = 1.0,
    time_exp: float = 1.0, device="cpu",
) -> ForwardProcess:
    base = uniform_base_rate(S, rate_const)
    ev, V, Vi = _symmetric(base)
    if t_func == "log_sqr":
        schedule, params = SCHEDULE_LOG_SQR, ()
    elif t_func == "sqrt_cos":
        schedule, params = SCHEDULE_SQRT_COS, ()
    elif t_func == "log":
        schedule, params = SCHEDULE_LOG, (float(time_base), float(time_exp))
    else:
        raise ValueError(f"unknown t_func {t_func}")
    return ForwardProcess(
        base, ev, V, Vi, kind="uniform_variant", schedule=schedule,
        schedule_params=params, renormalize=True, device=device,
    )


@registry.processes.register(name="GaussianTargetRate")
def make_gaussian_target(
    S: int, rate_sigma: float, Q_sigma: float, time_base: float,
    time_exp: float, device="cpu",
) -> ForwardProcess:
    base = gaussian_target_base_rate(S, rate_sigma, Q_sigma)
    eigvals, eigvecs = np.linalg.eig(base)
    inv_eigvecs = np.linalg.inv(eigvecs)
    # the spectrum is real (the matrix is similar to a symmetric one through
    # the detailed-balance weights): drop the zero imaginary parts
    return ForwardProcess(
        base, np.real(eigvals), np.real(eigvecs), np.real(inv_eigvecs),
        kind="gaussian_target", schedule=SCHEDULE_LOG,
        schedule_params=(float(time_base), float(time_exp)),
        renormalize=True, device=device,
    )


def build_process(cfg, device="cpu") -> ForwardProcess:
    """Build the forward process named by cfg.model.rate_name."""
    name = cfg.model.rate_name
    S = cfg.data.S
    m = cfg.model
    if name == "BirthDeathForwardBase":
        return make_birth_death(S, m.sigma_min, m.sigma_max, device=device)
    if name == "UniformRate":
        return make_uniform(S, m.rate_const, device=device)
    if name == "UniformVariantRate":
        return make_uniform_variant(
            S, m.rate_const, m.t_func, time_base=m.get("time_base", 1.0),
            time_exp=m.get("time_exp", 1.0), device=device,
        )
    if name == "GaussianTargetRate":
        return make_gaussian_target(
            S, m.rate_sigma, m.Q_sigma, m.time_base, m.time_exp, device=device
        )
    raise ValueError(f"unknown forward process {name}")
