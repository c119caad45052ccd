"""Port vs JAX: logits -> log-probs (`ops/logprob.py`), the ratio branch of
the reverse rates (per-sample and shared timestep), and the truncated
logistic head (`ops/logistic.py`), on numpy-seeded inputs.

Float32 on both sides with sums in another order. Log-probs agree within
1e-5 of their largest |value|; rates within 1e-5 of each row's largest
|value| off x, where the port holds exact zeros (JAX leaves the negative
diagonal R(x, x) there; every JAX caller masks it); the logistic logits
within 1e-6 of their largest |value|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.models.base import DiffusionModel as JaxModel
from ctdd_tpu.ops import forward_process as jfp
from ctdd_tpu.ops.logistic import logistic_bin_logits as jax_logistic
from ctdd_tpu.ops.logprob import logprob_with_logits as jax_logprob
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import DiffusionModel, create_model
from ctdd_tpu_torch.ops import forward_process as tfp
from ctdd_tpu_torch.ops.logistic import logistic_bin_logits
from ctdd_tpu_torch.ops.logprob import logprob_with_logits
from ctdd_tpu_torch.sampling import samplers as ts
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

N, D, S = 3, 7, 6
LOGIT_TYPES = ["direct", "reverse_prob", "reverse_logscale"]


def processes(kind: str):
    if kind == "gaussian":
        return (jfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0),
                tfp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0, device="cpu"))
    return (jfp.make_uniform_variant(S, rate_const=1.3, t_func="sqrt_cos"),
            tfp.make_uniform_variant(S, 1.3, "sqrt_cos", device="cpu"))


def inputs(seed=5):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((N, D, S))).astype(np.float32)
    x = rng.integers(0, S, (N, D)).astype(np.int32)
    t = np.array([0.05, 0.37, 0.9], np.float32)
    return logits, x, t


def assert_close(got, want, tol=1e-5):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def assert_rows_close_off_x(got, want, x):
    off_x = np.arange(S)[None, None, :] != x[..., None]
    scale = np.abs(np.where(off_x, want, 0.0)).max(axis=-1, keepdims=True)
    err = np.where(off_x, np.abs(got - want), 0.0) / scale
    assert err.max() <= 1e-5, err.max()
    assert np.all(got[~off_x] == 0.0)


@pytest.mark.parametrize("kind", ["gaussian", "uniform_variant"])
@pytest.mark.parametrize("logit_type", LOGIT_TYPES)
def test_logprob_with_logits_matches_jax(logit_type, kind):
    jproc, tproc = processes(kind)
    logits, x, t = inputs()
    target = np.roll(x, 1, axis=1)
    want_all, want_xt = jax_logprob(logit_type, jproc, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(logits), jnp.asarray(target))
    got_all, got_xt = logprob_with_logits(logit_type, tproc, torch.from_numpy(x),
                                          torch.from_numpy(t), torch.from_numpy(logits),
                                          torch.from_numpy(target))
    assert got_all.shape == (N, D, S) and got_xt.shape == (N, D)
    assert_close(got_all.numpy(), np.asarray(want_all))
    assert_close(got_xt.numpy(), np.asarray(want_xt))


@pytest.mark.parametrize("kind", ["gaussian", "uniform_variant"])
@pytest.mark.parametrize("logit_type", LOGIT_TYPES)
def test_ratio_reverse_rates_match_jax_zeroed_at_x(logit_type, kind):
    """The per-sample function: rates 0 at x, equal off it; the ratio (not
    masked) equal everywhere."""
    jproc, tproc = processes(kind)
    logits, x, t = inputs()
    kw = dict(rate_param="ratio", logit_type=logit_type, eps=1e-9)
    want, want_ratio = js.reverse_rates(
        JaxModel(module=None, process=jproc, cfg=None), None, jnp.asarray(logits),
        jnp.asarray(x), jnp.asarray(t), **kw)
    got, got_ratio = ts.reverse_rates(
        DiffusionModel(net=None, process=tproc, cfg=None), None, torch.from_numpy(logits),
        torch.from_numpy(x), torch.from_numpy(t), **kw)
    assert_rows_close_off_x(got.numpy(), np.asarray(want), x)
    assert_close(got_ratio.numpy(), np.asarray(want_ratio))
    # JAX leaves R(x, x) * 1 < 0 at x: the entry the port zeroes
    at_x = np.take_along_axis(np.asarray(want), x[..., None].astype(np.int64), -1)
    assert np.all(at_x < 0)


@pytest.mark.parametrize("logit_type", LOGIT_TYPES)
def test_ratio_reverse_rates_shared_match_jax_zeroed_at_x(logit_type):
    jproc, tproc = processes("gaussian")
    logits, x, _ = inputs(seed=6)
    kw = dict(rate_param="ratio", logit_type=logit_type, eps=1e-9)
    want = np.asarray(js.reverse_rates_shared(jproc, jnp.asarray(logits), jnp.asarray(x),
                                              jnp.float32(0.37), **kw))
    got = ts.reverse_rates_shared(tproc, torch.from_numpy(logits), torch.from_numpy(x),
                                  0.37, **kw).numpy()
    assert_rows_close_off_x(got, want, x)


@pytest.mark.parametrize("preset", ["hollow_synthetic", "hollow_synthetic_rmdirect"])
def test_sampler_rev_rates_take_the_ratio_branch(preset):
    """A CRM preset's sampler computes its step's rates on the ratio path:
    equal to `reverse_rates_shared` of its logits, 0 at x, and no launch of
    the p0t reverse-rates kernel's wrapper."""
    from ctdd_tpu_torch.ops import rate_kernels

    cfg = get_preset(preset)
    cfg.model.num_layers, cfg.model.embed_dim, cfg.model.qkv_dim = 1, 16, 16
    model = create_model(cfg, device="cpu")
    model.net.eval()
    sampler = ts.get_sampler(cfg)
    assert sampler.rate_param == "ratio"
    x = torch.randint(0, 2, (4, 32), generator=torch.Generator().manual_seed(0),
                      dtype=torch.int32)
    before = rate_kernels.reverse_rates.launches
    with torch.no_grad():
        rev = sampler._rev_rates(model, model.net, x, 0.4)
        want = ts.reverse_rates_shared(model.process, sampler._logits(model, model.net, x, 0.4),
                                       x, 0.4, rate_param="ratio",
                                       logit_type=cfg.loss.logit_type, eps=1e-9)
    assert rate_kernels.reverse_rates.launches == before
    torch.testing.assert_close(rev, want, rtol=0, atol=0)
    assert torch.all(rev.gather(-1, x.long()[..., None]) == 0)
    assert torch.all(rev >= 0)


@pytest.mark.parametrize("fix_logistic", [False, True])
def test_logistic_bin_logits_match_jax(fix_logistic):
    rng = np.random.default_rng(3)
    mu = np.tanh(rng.standard_normal((4, 9))).astype(np.float32)
    log_scale = (rng.standard_normal((4, 9)) - 1.0).astype(np.float32)
    want = np.asarray(jax_logistic(jnp.asarray(mu), jnp.asarray(log_scale), 16, fix_logistic))
    got = logistic_bin_logits(torch.from_numpy(mu), torch.from_numpy(log_scale), 16,
                              fix_logistic).numpy()
    assert got.shape == (4, 9, 16)
    assert_close(got, want, tol=1e-6)
