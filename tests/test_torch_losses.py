"""Port vs JAX: the CTElbo and NLLOriginal losses at the tiny flagship
geometry, and the loss pieces they draw from.

The same flax weights on both sides (`unet_params_from_flax`), the same
injected times and (x_t, x̃), dropout off. The times are early (t <= 0.03):
later, at this geometry (S=8), the chain has mixed, the ELBO no longer
depends on the network and its float32 gradient is rounding noise on both
sides (checked against a float64 port: noise of order 1e-9 on a true
gradient of 1e-17). Tolerances: the loss to rtol 1e-5, logits to 1e-5,
each gradient leaf to 1e-4 of its largest |g| (float32 on both sides, other
conv and reduction orders; measured 2e-6 to 6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.losses import losses as JL
from ctdd_tpu.ops import indexing as jidx
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.convert import unet_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.ops import indexing as tidx
from ctdd_tpu_torch.ops.forward_process import make_gaussian_target, make_uniform
from tests.test_loss_golden import numpy_ctelbo
from tests.test_torch_unet import flagship_cfgs, one_torch_thread, seeded_flax_params  # noqa: F401

TS = (0.01, 0.02, 0.03)


def tiny_pair(scale=0.05):
    """(JAX cfg, port cfg, JAX model, flax params, port model with them)."""
    cfg, tcfg = flagship_cfgs("tiny")
    jmodel, params = seeded_flax_params(cfg, seed=1, scale=scale)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(unet_params_from_flax(params, tcfg))
    return cfg, tcfg, jmodel, params, tmodel


def injected(tmodel, seed=0, ts=TS):
    """x0, ts and (x_t, x̃) drawn once by the port's own samplers, as numpy."""
    D, S = tmodel.cfg.model.concat_dim, tmodel.cfg.data.S
    x0 = np.random.default_rng(seed).integers(0, S, (len(ts), D)).astype(np.int32)
    ts = np.asarray(ts, np.float32)
    t = torch.from_numpy(ts)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(seed),
                                  tmodel.transition(t), tmodel.rate(t),
                                  torch.from_numpy(x0))
    return x0, ts, xt.numpy(), xtl.numpy()


def port_grads(tmodel, fn):
    """fn(params) -> scalar over fresh leaf copies of the port net's weights."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in tmodel.net.named_parameters()}
    value = fn(p)
    return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))


def assert_grads_close(jgrads, tgrads, tcfg, rel=1e-4):
    want = unet_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        scale = want[k].abs().max().item()
        err = (g - want[k]).abs().max().item()
        assert err <= rel * max(scale, 1e-30), (k, err, scale)


@pytest.mark.parametrize("one_forward_pass", [True, False])
def test_ctelbo_terms_match_jax(one_forward_pass):
    cfg, tcfg, jmodel, params, tmodel = tiny_pair()
    x0, ts, xt, xtl = injected(tmodel)
    eps = cfg.loss.eps_ratio

    def jax_terms(p):
        return JL._ctelbo_terms(
            jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(ts), eps,
            one_forward_pass, False, None, samples=(jnp.asarray(xt), jnp.asarray(xtl)))

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jax_terms, has_aux=True))(params)
    logits = {}

    def port_terms(p):
        value, logits["x"] = TL._ctelbo_terms(
            tmodel, p, None, torch.from_numpy(x0), torch.from_numpy(ts), eps,
            one_forward_pass, False, samples=(torch.from_numpy(xt), torch.from_numpy(xtl)))
        return value

    tl, tg = port_grads(tmodel, port_terms)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(logits["x"].detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    assert_grads_close(jg, tg, tcfg)


@pytest.mark.parametrize("name", ["CTElbo", "NLLOriginal"])
def test_losses_match_jax(name, monkeypatch):
    """calc_loss with the draws patched to the injected ones on both sides;
    CTElbo with nll_weight 0.5 so its CE term counts."""
    cfg, tcfg, jmodel, params, tmodel = tiny_pair()
    for c in (cfg, tcfg):
        c.loss.name = name
        c.loss.nll_weight = 0.5
    x0, ts, xt, xtl = injected(tmodel)
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(ts))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(ts))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    monkeypatch.setattr(TL, "sample_xt", lambda *a: torch.from_numpy(xt))
    jloss = JL.NLLOriginal(cfg) if name == "NLLOriginal" else JL.CTElbo(cfg)
    tloss = TL.get_loss(tcfg)
    assert type(tloss).__name__ == name
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), train=False)))(params)
    tl, tg = port_grads(tmodel, lambda p: tloss.calc_loss(
        tmodel, p, torch.Generator(), torch.from_numpy(x0), train=False))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(jg, tg, tcfg)


def test_ctelbo_matches_dense_numpy():
    """The port's ELBO vs the per-element numpy transcription of the
    reference formulas (rtol 2e-4, as tests/test_loss_golden.py)."""
    cfg = get_preset("mlp_synthetic")
    cfg.data.shape = [5]
    cfg.model.concat_dim = 5
    cfg.model.d_model = 8
    cfg.model.hidden_dim = 16
    cfg.model.num_layers = 1
    cfg.model.temb_dim = 4
    cfg.data.S = 3
    cfg.model.rate_const = 1.3
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    B, D, S = 3, 5, 3
    rng = np.random.RandomState(1)
    x0 = torch.from_numpy(rng.randint(0, S, (B, D)).astype(np.int32))
    x_t = torch.from_numpy(rng.randint(0, S, (B, D)).astype(np.int32))
    x_tilde = x_t.clone()
    x_tilde[torch.arange(B), torch.from_numpy(rng.randint(0, D, B))] = torch.from_numpy(
        rng.randint(0, S, (B,)).astype(np.int32))
    ts = torch.tensor([0.3, 0.55, 0.8])
    with torch.no_grad():
        neg_elbo, logits = TL._ctelbo_terms(model, model.net, None, x0, ts, 1e-9, True,
                                            False, samples=(x_t, x_tilde))
    want = numpy_ctelbo(
        model.transition(ts).double().numpy(), model.rate(ts).double().numpy(),
        x0.numpy(), x_t.numpy(), x_tilde.numpy(), logits.double().numpy(), 1e-9)
    np.testing.assert_allclose(float(neg_elbo), want, rtol=2e-4)


def test_sample_xt_statistics():
    """x_t ~ q_{t|0}: empirical marginals match the transition rows (4000
    draws; atol 0.03, ~4 standard errors)."""
    proc = make_uniform(3, rate_const=1.0, device="cpu")
    qt0 = proc.transition(torch.tensor([0.5]))
    x_t = TL.sample_xt(torch.Generator().manual_seed(0), qt0,
                       torch.zeros((1, 4000), dtype=torch.int32))
    assert x_t.dtype == torch.int32
    emp = np.bincount(x_t.numpy().ravel(), minlength=3) / 4000
    np.testing.assert_allclose(emp, qt0[0, 0].numpy(), atol=0.03)


def test_sample_xtilde_one_dim_by_rate_mass():
    """x̃ differs from x_t in exactly one dim; the dim is drawn ∝ the
    off-diagonal rate mass at x_t and the new state ∝ the off-diagonal rates.
    Counts over 20000 rows against their expectations given each row's x_t:
    within 4 binomial standard errors."""
    S, B, D = 5, 20000, 3
    proc = make_gaussian_target(S, 1.0, 4.0, 3.0, 100.0, device="cpu")
    ts = torch.full((B,), 0.2)
    qt0, rate = proc.transition(ts), proc.rate(ts)
    x0 = torch.from_numpy(np.random.default_rng(0).integers(0, S, (B, D)).astype(np.int32))
    x_t, x_tilde = TL.sample_xt_xtilde(torch.Generator().manual_seed(1), qt0, rate, x0)
    changed = x_t != x_tilde
    assert (changed.sum(1) == 1).all()
    off = tidx.zero_at(tidx.rows(rate, x_t), x_t).double()  # (B, D, S)
    p_dim = off.sum(-1) / off.sum((1, 2))[:, None]  # (B, D)
    dim = changed.long().argmax(1)
    p_new = off[torch.arange(B), dim] / off[torch.arange(B), dim].sum(-1, keepdim=True)
    new = x_tilde[torch.arange(B), dim].long()
    for got, p in ((np.bincount(dim.numpy(), minlength=D), p_dim),
                   (np.bincount(new.numpy(), minlength=S), p_new)):
        want = p.sum(0).numpy()
        sd = np.sqrt((p * (1 - p)).sum(0).numpy())
        assert (np.abs(got - want) <= 4 * sd + 1).all(), (got, want, sd)


def test_elems_and_diag_match_jax():
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((3, 6, 6)).astype(np.float32)
    r = rng.integers(0, 6, (3, 7)).astype(np.int32)
    c = rng.integers(0, 6, (3, 7)).astype(np.int32)
    got = tidx.elems(torch.from_numpy(mat), torch.from_numpy(r), torch.from_numpy(c))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jidx.elems(jnp.asarray(mat), jnp.asarray(r), jnp.asarray(c))))
    np.testing.assert_array_equal(tidx.diag(torch.from_numpy(mat)).numpy(),
                                  np.asarray(jidx.diag(jnp.asarray(mat))))


@pytest.mark.parametrize("name", ["log1mexp", "log_minus_exp", "safe_log",
                                  "mean_cross_entropy"])
def test_math_helpers_match_jax(name):
    """float32 on both sides: rtol 1e-6 (safe_log's -1e9 for p <= 0 exact)."""
    from ctdd_tpu.utils import math as jm
    from ctdd_tpu_torch.utils import math as tm

    rng = np.random.default_rng(0)
    a = rng.uniform(0.01, 5.0, (4, 6)).astype(np.float32)
    b = (a - rng.uniform(0.1, 2.0, (4, 6))).astype(np.float32)
    p = np.where(rng.random((4, 6)) < 0.3, 0.0, a).astype(np.float32)
    args = {"log1mexp": (a,), "log_minus_exp": (a, b), "safe_log": (p,),
            "mean_cross_entropy": (rng.standard_normal((3, 5, 7)).astype(np.float32),
                                   rng.integers(0, 7, (3, 5)).astype(np.int32))}[name]
    want = np.asarray(getattr(jm, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tm, name)(*(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
