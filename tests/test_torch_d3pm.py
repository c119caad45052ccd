"""Port vs JAX: the D3PM baseline (ctdd_tpu_torch/d3pm against ctdd_tpu/d3pm)
on the CPU at tiny sizes.

The tables are held bit-equal in float32 (both packages build them with the
same numpy arithmetic). Logits are held to 1e-5 of the largest |logit|, the
losses and the bound to rel 1e-5 (float32 sums and products in another
order). The stochastic functions take JAX's draws rebuilt from its key
schedule: `jax.random.categorical` adds `jax.random.gumbel` of its key to
the logits; the ancestral step's uniforms are `jax.random.uniform` of its key
on [tiny, 1). States drawn that way are identical.
"""

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.d3pm import diffusion as JD
from ctdd_tpu.d3pm import utils as JU
from ctdd_tpu_torch.d3pm import diffusion as TD
from ctdd_tpu_torch.d3pm import utils as TU
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

T, S, B, D = 8, 6, 3, 5
LOGIT_TOL = 1e-5  # share of the largest |logit|
REL_TOL = 1e-5
TINY = float(np.finfo(np.float32).tiny)


def model_cfg(mat="uniform", loss_type="kl", bands=None, kind="linear", S=S, T=T,
              output="logits"):
    return ml_collections.ConfigDict(dict(
        type=kind, start=0.02, stop=0.5, num_timesteps=T, model_prediction="x_start",
        model_output=output, transition_mat_type=mat, transition_bands=bands,
        loss_type=loss_type, hybrid_coeff=0.01, num_pixel_vals=S))


def pair(**kw):
    cfg = model_cfg(**kw)
    return JD.make_diffusion(cfg), TD.make_diffusion(cfg, device="cpu")


def table(seed=0, S=S):
    return np.random.RandomState(seed).randn(S, S).astype(np.float32)


def model_fns(S=S, seed=0):
    """The same network in both packages: logits = W[x] * (1 + t)."""
    W = table(seed, S)

    def jfn(x, t):
        return jnp.asarray(W)[x] * (1 + t)[:, None, None]

    def tfn(x, t):
        return torch.from_numpy(W)[x.long()] * (1 + t)[:, None, None].float()

    return jfn, tfn


def states(seed, shape=(B, D), S=S):
    return np.random.RandomState(seed).randint(0, S, shape).astype(np.int32)


def close_logits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_array_less(np.abs(got - want), LOGIT_TOL * scale + 1e-30)


def close_rel(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=REL_TOL, atol=REL_TOL * np.abs(np.asarray(want)).max())


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("kind", ["linear", "cosine", "jsd"])
def test_betas_equal(kind):
    cfg = model_cfg(kind=kind, T=50)
    np.testing.assert_array_equal(TD.get_diffusion_betas(cfg), JD.get_diffusion_betas(cfg))


@pytest.mark.parametrize("mat,bands", [("uniform", None), ("uniform", 2), ("gaussian", None),
                                       ("gaussian", 2), ("absorbing", None)])
def test_tables_bit_equal(mat, bands):
    """The one-step, cumulative and transposed tables in float32, and each
    float64 one-step matrix."""
    jd, td = pair(mat=mat, bands=bands)
    for name in ("q_onestep_mats", "q_mats", "transpose_q_onestep_mats"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    for b in TD.get_diffusion_betas(model_cfg()):
        if mat == "uniform":
            got, want = TD._uniform_band_mat(b, S, bands), JD._uniform_band_mat(b, S, bands)
        elif mat == "gaussian":
            got, want = TD._gaussian_band_mat(b, S, bands), JD._gaussian_band_mat(b, S, bands)
        else:
            got, want = TD._absorbing_mat(b, S), JD._absorbing_mat(b, S)
        np.testing.assert_array_equal(got, want)


def test_mnist_d3pm_gaussian_rows_bit_equal_at_full_width():
    """S=256: the vectorized band matrices keep JAX's row sums (the diagonal)
    bit for bit, at the first, a middle and the last beta of the preset."""
    betas = JD.get_diffusion_betas(jax_get_preset("mnist_d3pm").model)
    for b in betas[[0, 499, 999]]:
        np.testing.assert_array_equal(TD._gaussian_band_mat(b, 256, None),
                                      JD._gaussian_band_mat(b, 256, None))


def test_utils_match():
    rng = np.random.RandomState(0)
    a, b = (rng.randn(B, D, S).astype(np.float32) for _ in range(2))
    p, q = (np.exp(v) / np.exp(v).sum(-1, keepdims=True) for v in (a, b))
    x = states(1)
    ta, tb, tp, tq = (torch.from_numpy(v) for v in (a, b, p, q))
    close_rel(TU.meanflat(ta).numpy(), JU.meanflat(jnp.asarray(a)))
    close_rel(TU.log_min_exp(ta + 10.0, tb).numpy(), JU.log_min_exp(jnp.asarray(a) + 10.0, b))
    close_rel(TU.categorical_kl_logits(ta, tb).numpy(), JU.categorical_kl_logits(a, b))
    close_rel(TU.categorical_kl_probs(tp, tq).numpy(), JU.categorical_kl_probs(p, q))
    close_rel(TU.categorical_log_likelihood(t64(x), ta).numpy(),
              JU.categorical_log_likelihood(jnp.asarray(x), a))
    close_rel(TU.normalize_data(ta).numpy(), JU.normalize_data(jnp.asarray(a)))


@pytest.mark.parametrize("mat", ["uniform", "gaussian", "absorbing"])
def test_q_probs_and_posterior_logits(mat):
    """q_probs exactly (a gather against a one-hot product); the posterior
    logits of both branches with t = 0 in the batch."""
    jd, td = pair(mat=mat)
    x0, xt = states(0), states(1)
    t = np.array([0, 3, T - 1], np.int32)
    np.testing.assert_array_equal(td.q_probs(t64(x0), t64(t)).numpy(),
                                  np.asarray(jd.q_probs(jnp.asarray(x0), jnp.asarray(t))))
    close_logits(td.q_posterior_logits(t64(x0), t64(xt), t64(t), False).numpy(),
                 jd.q_posterior_logits(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t), False))
    logits = np.random.RandomState(2).randn(B, D, S).astype(np.float32)
    close_logits(td.q_posterior_logits(torch.from_numpy(logits), t64(xt), t64(t), True).numpy(),
                 jd.q_posterior_logits(jnp.asarray(logits), jnp.asarray(xt), jnp.asarray(t),
                                       True))


def test_logistic_pars_and_p_logits():
    jd, td = pair(mat="gaussian", output="logistic_pars")
    rng = np.random.RandomState(3)
    loc = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    log_scale = rng.uniform(-4, 0, (B, D)).astype(np.float32)
    close_logits(td._get_logits_from_logistic_pars(torch.from_numpy(loc),
                                                   torch.from_numpy(log_scale)).numpy(),
                 jd._get_logits_from_logistic_pars(jnp.asarray(loc), jnp.asarray(log_scale)))
    x, t = states(4), np.array([0, 2, T - 1], np.int32)
    jd, td = pair(mat="gaussian")
    jfn, tfn = model_fns()
    got, got_x0 = td.p_logits(tfn, t64(x), t64(t))
    want, want_x0 = jd.p_logits(jfn, jnp.asarray(x), jnp.asarray(t))
    close_logits(got.numpy(), want)
    close_logits(got_x0.numpy(), want_x0)


def test_q_sample_with_jax_gumbel():
    jd, td = pair()
    x0, t = states(5), np.array([1, 4, T - 1], np.int32)
    key = jax.random.PRNGKey(7)
    want = jd.q_sample(key, jnp.asarray(x0), jnp.asarray(t))
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (B, D, S))))
    got = td.q_sample(t64(x0), t64(t), gumbel=gumbel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vb_terms_and_prior_bpd():
    for mat in ("uniform", "absorbing"):
        jd, td = pair(mat=mat)
        jfn, tfn = model_fns()
        x0, xt, t = states(6), states(7), np.array([0, 3, T - 1], np.int32)
        got, _ = td.vb_terms_bpd(tfn, t64(x0), t64(xt), t64(t))
        want, _ = jd.vb_terms_bpd(jfn, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))
        close_rel(got.numpy(), want)
        close_rel(td.prior_bpd(t64(x0)).numpy(), jd.prior_bpd(jnp.asarray(x0)))


@pytest.mark.parametrize("loss_type", ["kl", "cross_entropy_x_start", "hybrid"])
def test_training_losses_with_jax_draws(loss_type):
    """`D3PMLoss.calc_loss`'s t and x_t noise as JAX draws them:
    kt, kl = split(key); t = randint(kt); k_noise = split(kl)[0]."""
    jd, td = pair(loss_type=loss_type)
    jfn, tfn = model_fns()
    x0 = states(8)
    key = jax.random.PRNGKey(11)
    kt, kl = jax.random.split(key)
    t = jax.random.randint(kt, (B,), 0, T)
    want = jd.training_losses(kl, jfn, jnp.asarray(x0), t)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(jax.random.split(kl)[0], (B, D, S))))
    got = td.training_losses(tfn, t64(x0), t64(t), gumbel=gumbel)
    close_rel(got.numpy(), want)


def test_p_sample_and_p_sample_loop_with_jax_uniforms():
    """One step at t with a zero in the batch, then the whole T=8 chain:
    x_T = randint(k_init), step i's uniforms from split(k_scan, T)[i]."""
    jd, td = pair(mat="gaussian")
    jfn, tfn = model_fns()
    x, t = states(9), np.array([0, 5, T - 1], np.int32)
    key = jax.random.PRNGKey(12)
    want, want_p = jd.p_sample(key, jfn, jnp.asarray(x), jnp.asarray(t))
    u = np.asarray(jax.random.uniform(key, (B, D, S), minval=TINY, maxval=1.0))
    got, got_p = td.p_sample(tfn, t64(x), t64(t), u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    close_rel(got_p.numpy(), want_p)

    key = jax.random.PRNGKey(13)
    want = np.asarray(jd.p_sample_loop(key, jfn, (B, D)))
    k_init, k_scan = jax.random.split(key)
    x_init = t64(jax.random.randint(k_init, (B, D), 0, S))
    uniforms = [torch.from_numpy(np.array(jax.random.uniform(k, (B, D, S), minval=TINY,
                                                               maxval=1.0)))
                for k in jax.random.split(k_scan, T)]
    got = td.p_sample_loop(tfn, (B, D), x_init=x_init, uniforms=uniforms)
    assert (got != x_init).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_p_sample_loop_draws_its_own_noise():
    """With a generator: states in range, reproducible from the seed; the
    absorbing chain starts at S // 2."""
    for mat in ("uniform", "absorbing"):
        _, td = pair(mat=mat)
        _, tfn = model_fns()
        runs = [td.p_sample_loop(tfn, (B, D), torch.Generator().manual_seed(0))
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        assert runs[0].min() >= 0 and runs[0].max() < S
    assert (td.initial_states((B, D)) == S // 2).all()


def test_calc_bpd_loop_with_jax_draws():
    jd, td = pair()
    jfn, tfn = model_fns()
    x0 = states(14)
    key = jax.random.PRNGKey(15)
    want = jd.calc_bpd_loop(key, jfn, jnp.asarray(x0))
    gumbels = [torch.from_numpy(np.array(jax.random.gumbel(k, (B, D, S))))
               for k in jax.random.split(key, T)]
    got = td.calc_bpd_loop(tfn, t64(x0), gumbels=gumbels)
    for name in ("total", "vbterms", "prior"):
        close_rel(got[name].numpy(), want[name])
    assert got["vbterms"].shape == (B, T)


def test_posterior_product_has_no_tf32():
    """The x_start-logits branch's product runs in float32 without TF32
    even where the caller turned TF32 on (the flags come back after)."""
    from ctdd_tpu_torch.utils.device import tf32

    _, td = pair()
    logits = torch.from_numpy(np.random.RandomState(16).randn(B, D, S).astype(np.float32))
    xt, t = t64(states(17)), t64(np.array([1, 2, 3]))
    want = td.q_posterior_logits(logits, xt, t, True)
    with tf32(True):
        got = td.q_posterior_logits(logits, xt, t, True)
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(got, want)


def test_bad_betas_raise():
    with pytest.raises(ValueError, match="betas"):
        TD.CategoricalDiffusion(np.array([0.1, 1.5]), "x_start", "logits", "uniform", None,
                                "kl", 0.01, S, device="cpu")
