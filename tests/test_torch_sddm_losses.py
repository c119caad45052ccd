"""Port vs JAX: the SDDM and CRM losses (SDDMElbo, ScoreElbo, CatRM,
CatRMNLL) and the rest of the tauLDR family (NLL, CTElboLambda), on the tiny
hollow network with the flax weights carried across.

The losses draw their noise inside, so the draws are injected on both
sides: `_sample_ts`, `sample_xt_xtilde` and `sample_xt` are patched in both
modules (nothing in the JAX package changes), and `_catrm_comp_loss` is
called directly. Dropout off. Tolerances: the loss to rtol 1e-5; each
gradient leaf to 1e-4 of its largest |g| (float32 on both sides, other
reduction orders). Without injection, statistics: the times' ranges, and the
mean loss over 24 draws on each side within 4 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.losses import losses as JL
from ctdd_tpu_torch.convert import hollow_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import create_model
from test_torch_hollow import D, S, seeded_params, tiny_cfgs
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

TS = (0.05, 0.3, 0.7)

LOSSES = {
    "NLL": dict(name="NLL"),
    "CTElboLambda": dict(name="CTElboLambda"),
    "SDDMElbo": dict(name="SDDMElbo", nll_weight=0.3),
    "SDDMElbo_two_passes": dict(name="SDDMElbo", nll_weight=0.3, one_forward_pass=False),
    "ScoreElbo": dict(name="ScoreElbo", nll_weight=0.3),
    "ScoreElbo_direct": dict(name="ScoreElbo", nll_weight=0.3, logit_type="direct"),
    "ScoreElbo_logscale": dict(name="ScoreElbo", nll_weight=0.3,
                               logit_type="reverse_logscale"),
    "CatRM_rm": dict(name="CatRM", loss_type="rm", ce_coeff=0.2),
    "CatRM_mle": dict(name="CatRM", loss_type="mle"),
    "CatRM_elbo": dict(name="CatRM", loss_type="elbo", logit_type="direct"),
    "CatRMNLL": dict(name="CatRMNLL", loss_type="mle", nll_weight=0.3),
}


def pair(loss_kw, seed=1):
    """(JAX cfg, port cfg, JAX model, flax params, port model with them)."""
    cfg, tcfg = tiny_cfgs("hollow_synthetic")
    for c in (cfg, tcfg):
        c.training.n_iters = 100
        for k, v in loss_kw.items():
            c.loss[k] = v
    jmodel, params = seeded_params(cfg, seed=seed, scale=0.3)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(hollow_params_from_flax(params, tmodel.net))
    return cfg, tcfg, jmodel, params, tmodel


def injected(tmodel, seed=0, ts=TS):
    """x0, ts and (x_t, x̃) drawn once by the port's own samplers, as numpy."""
    x0 = np.random.default_rng(seed).integers(0, S, (len(ts), D)).astype(np.int32)
    ts = np.asarray(ts, np.float32)
    t = torch.from_numpy(ts)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(seed), tmodel.transition(t),
                                  tmodel.rate(t), torch.from_numpy(x0))
    return x0, ts, xt.numpy(), xtl.numpy()


def port_grads(tmodel, fn):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tmodel.net.named_parameters()}
    value = fn(p)
    return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))


def assert_grads_close(jgrads, tgrads, net, rel=1e-4):
    """Each leaf within `rel` of its largest |g|. The key biases (of the
    self-attention and of the readout's cross-attention, `Dense_1`) have a
    zero gradient in exact arithmetic (the softmax over keys is invariant to
    them), so both sides hold rounding noise there: those leaves are held
    within `rel` of the network's largest |g|."""
    want = hollow_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), net)
    assert set(want) == set(tgrads)
    top = max(w.abs().max().item() for w in want.values())
    for k, g in tgrads.items():
        key_bias = k.endswith(("key.bias", "CrossAttention_0.Dense_1.bias"))
        scale = top if key_bias else want[k].abs().max().item()
        err = (g - want[k]).abs().max().item()
        assert err <= rel * max(scale, 1e-30), (k, err, scale)


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_match_jax_with_injected_noise(case, monkeypatch):
    cfg, tcfg, jmodel, params, tmodel = pair(LOSSES[case])
    x0, ts, xt, xtl = injected(tmodel)
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(ts))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(ts))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    monkeypatch.setattr(TL, "sample_xt", lambda *a: torch.from_numpy(xt))
    name = cfg.loss.name
    jloss, tloss = getattr(JL, name)(cfg), TL.get_loss(tcfg)
    assert type(tloss).__name__ == name
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), n_iter=37, train=False)))(params)
    tl, tg = port_grads(tmodel, lambda p: tloss.calc_loss(
        tmodel, p, torch.Generator(), torch.from_numpy(x0), n_iter=37, train=False))
    assert np.isfinite(float(jl))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert_grads_close(jg, tg, tmodel.net)


@pytest.mark.parametrize("loss_type", ["rm", "mle", "elbo"])
def test_catrm_comp_loss_matches_jax(loss_type):
    """The per-dimension CRM losses on the same log-probs."""
    cfg, tcfg, jmodel, _, tmodel = pair(dict(name="CatRM", loss_type=loss_type))
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, D, S)).astype(np.float32)
    ll_all = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    xt = rng.integers(0, S, (3, D)).astype(np.int32)
    ll_xt = np.take_along_axis(ll_all, xt[..., None].astype(np.int64), -1)[..., 0]
    ts = np.asarray(TS, np.float32)
    want = np.asarray(JL._catrm_comp_loss(cfg, jmodel, jnp.asarray(xt), jnp.asarray(ts),
                                          jnp.asarray(ll_all), jnp.asarray(ll_xt)))
    got = TL._catrm_comp_loss(tcfg, tmodel, torch.from_numpy(xt), torch.from_numpy(ts),
                              torch.from_numpy(ll_all), torch.from_numpy(ll_xt)).numpy()
    assert got.shape == (3, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sddm_elbo_terms_take_injected_samples():
    """`_sddm_elbo_terms(samples=...)` (the port's injection point, as
    `_ctelbo_terms` has) equals the drawn path on the same draws."""
    _, tcfg, _, _, tmodel = pair(dict(name="ScoreElbo"))
    x0, ts, xt, xtl = injected(tmodel, seed=3)
    args = (tcfg, tmodel, tmodel.net, None, torch.from_numpy(x0), torch.from_numpy(ts),
            1e-9, True, False)
    given = TL._sddm_elbo_terms(*args, samples=(torch.from_numpy(xt), torch.from_numpy(xtl)))
    gen = torch.Generator().manual_seed(3)
    drawn = TL._sddm_elbo_terms(*args[:3], gen, *args[4:])
    for a, b in zip(given, drawn):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name,lo,hi", [("CatRM", 0.007, 0.99999), ("ScoreElbo", 0.007, 0.99999),
                                        ("CatRMNLL", 0.007, 0.5)])
def test_loss_times_cover_their_range(name, lo, hi, monkeypatch):
    """The times each loss draws: [min_time, 1) clamped at 0.99999 for the
    SDDM ELBOs and CatRM, [min_time, training.max_t) for CatRMNLL."""
    _, tcfg, _, _, tmodel = pair(dict(name=name, loss_type="rm"))
    tcfg.training.max_t = 0.5
    seen = []
    real = TL._sample_ts

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(TL, "_sample_ts", spy)
    x0 = torch.from_numpy(np.random.default_rng(0).integers(0, S, (64, D)).astype(np.int32))
    with torch.no_grad():
        for i in range(8):
            TL.get_loss(tcfg).calc_loss(tmodel, tmodel.net, torch.Generator().manual_seed(i),
                                        x0, train=False)
    ts = torch.cat(seen)
    assert ts.min() >= lo and ts.max() <= hi
    assert ts.min() < lo + 0.05 and ts.max() > hi - 0.05


@pytest.mark.parametrize("case", ["ScoreElbo", "CatRM_mle"])
def test_mean_loss_matches_jax_statistically(case):
    """Draws from each package's own generator: the mean over 24 draws agrees
    within 4 standard errors of the difference."""
    cfg, tcfg, jmodel, params, tmodel = pair(LOSSES[case])
    x0 = np.random.default_rng(0).integers(0, S, (16, D)).astype(np.int32)
    jloss, tloss = getattr(JL, cfg.loss.name)(cfg), TL.get_loss(tcfg)
    jfn = jax.jit(lambda k: jloss.calc_loss(jmodel, params, k, jnp.asarray(x0), train=False))
    jv = np.array([float(jfn(jax.random.PRNGKey(i))) for i in range(24)])
    with torch.no_grad():
        tv = np.array([float(tloss.calc_loss(tmodel, tmodel.net,
                                             torch.Generator().manual_seed(i),
                                             torch.from_numpy(x0), train=False))
                       for i in range(24)])
    se = np.sqrt(jv.var(ddof=1) / 24 + tv.var(ddof=1) / 24)
    assert abs(jv.mean() - tv.mean()) <= 4 * se, (jv.mean(), tv.mean(), se)
