"""Port vs JAX: the energy-based path — the three score functions, the two
mutation enumerators, the EBMAux and BinEBMAux losses, and EBM logits
sampled by LBJF (`CRMebmLBJF`) and ExactSampling.

Tiny widths (E=8, 2 heads, 2 layers, D=5); every flax leaf redrawn from
seeded normals (std 0.3) and carried across by `hollow_params_from_flax`.
Eval mode. Tolerances: energies and logits to 1e-5 of the largest |value|;
losses to rtol 1e-5, with the draws injected on both sides by patching
`_sample_ts` and `sample_xt` in both loss modules. Gradients: these losses
are log-softmaxes over energy differences, so a leaf whose gradient is
small beside the net's (a LayerNorm bias at 4% of the largest |g|) carries
float32 rounding of the net's scale on both sides (~1e-7 against ~1e-3).
Each leaf is held to a float64 gradient of the same loss (the port's net in
float64): the port's float32 error there at most 4x JAX's own largest
float32 error on the same gradient, which itself is within 1e-4 of the
net's largest |g|. Samplers: the JAX sampler's whole run from one key; the
port's steps take the same noise (x_T, and the Gumbel draws that
`jax.random.categorical` adds, rebuilt from JAX's key schedule): states
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.base import FrozenCfg
from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.models.base import compose as jax_compose
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu.networks import ebm as jebm
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import hollow_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import compose, create_model
from ctdd_tpu_torch.networks import ebm as tebm
from ctdd_tpu_torch.sampling import samplers as ts
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

D = 5
REL_TOL = 1e-5


def ebm_cfgs(S=2, **model):
    """(JAX cfg, port cfg) of `ebm_synthetic` at the tiny width."""
    cfg = jax_get_preset("ebm_synthetic")
    with cfg.unlocked():
        m = cfg.model
        m.embed_dim = m.qkv_dim = 8
        m.num_layers, m.mlp_dim, m.num_heads = 2, 12, 2
        cfg.data.S = S
        cfg.data.shape, m.concat_dim = [D], D
        cfg.sampler.num_steps = 6
        m.rate_name = "UniformVariantRate"  # the zoo entry's process
        for k, v in model.items():
            m[k] = v
    return cfg, Config(cfg.to_dict())


NETS = {
    "BinaryTransformerScoreFunc": 2, "BinaryMLPScoreFunc": 2, "CatMLPScoreFunc": 3,
}


def models(kind, S=None, seed=1, scale=0.3, **cfg_kw):
    """(JAX cfg, port cfg, JAX model, flax params, port model) of the score
    function `kind` bound to the preset's process."""
    cfg, tcfg = ebm_cfgs(S or NETS[kind], **cfg_kw)
    if kind == "BinaryTransformerScoreFunc":
        jmodel, tmodel = jax_create_model(cfg), create_model(tcfg, device="cpu")
    else:
        jmodel = jax_compose(cfg, getattr(jebm, kind)(cfg=FrozenCfg(cfg)))
        tmodel = compose(tcfg, getattr(tebm, kind)(tcfg), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32), jnp.full((2,), 0.5)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    tmodel.net.load_state_dict(hollow_params_from_flax(params, tmodel.net))
    tmodel.net.eval()
    return cfg, tcfg, jmodel, params, tmodel


def states(S, n=4, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, S, (n, D)).astype(np.int32),
            rng.uniform(0.02, 0.98, n).astype(np.float32))


def close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("kind", sorted(NETS))
def test_score_functions_match_jax(kind):
    _, _, jmodel, params, tmodel = models(kind)
    x, t = states(NETS[kind])
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert want.shape == (4,)
    close(got, want)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_all_mutation_logits_match_jax(kind):
    S = NETS[kind]
    _, _, jmodel, params, tmodel = models(kind)
    x, t = states(S)
    want = np.asarray(JL.ebm_all_mutation_logits(jmodel, params, jnp.asarray(x),
                                                 jnp.asarray(t), S))
    with torch.no_grad():
        got = TL.ebm_all_mutation_logits(tmodel, tmodel.net, torch.from_numpy(x),
                                         torch.from_numpy(t), S).numpy()
    assert want.shape == (4, D, S)
    close(got, want)


@pytest.mark.parametrize("kind", ["BinaryTransformerScoreFunc", "BinaryMLPScoreFunc"])
def test_bit_flip_logits_match_jax(kind):
    _, _, jmodel, params, tmodel = models(kind)
    x, t = states(2)
    want = np.asarray(JL.bin_ebm_flip_logits(jmodel, params, jnp.asarray(x),
                                             jnp.asarray(t)))
    with torch.no_grad():
        got = TL.bin_ebm_flip_logits(tmodel, tmodel.net, torch.from_numpy(x),
                                     torch.from_numpy(t)).numpy()
    assert want.shape == (4, D, 2)
    close(got, want)
    # on binary states the two enumerators agree: the all-mutation tiling
    # holds the unflipped row at s == x_d and the flipped one elsewhere
    with torch.no_grad():
        every = TL.ebm_all_mutation_logits(tmodel, tmodel.net, torch.from_numpy(x),
                                           torch.from_numpy(t), 2).numpy()
    close(got, every)


LOSSES = {
    "BinEBMAux_transformer": ("BinaryTransformerScoreFunc", "BinEBMAux", {}),
    "BinEBMAux_mlp_reverse_prob": ("BinaryMLPScoreFunc", "BinEBMAux",
                                   {"logit_type": "reverse_prob"}),
    "EBMAux_cat_mlp": ("CatMLPScoreFunc", "EBMAux", {}),
    "EBMAux_transformer": ("BinaryTransformerScoreFunc", "EBMAux", {}),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_match_jax_with_injected_draws(case, monkeypatch):
    kind, name, loss_kw = LOSSES[case]
    cfg, tcfg, jmodel, params, tmodel = models(kind)
    for c in (cfg, tcfg):
        c.loss.name = name
        for k, v in loss_kw.items():
            c.loss[k] = v
    x0, ts_ = states(NETS[kind], n=3, seed=5)
    xt, _ = states(NETS[kind], n=3, seed=6)
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(ts_))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(ts_))
    monkeypatch.setattr(TL, "sample_xt", lambda *a: torch.from_numpy(xt))
    jloss, tloss = getattr(JL, name)(cfg), TL.get_loss(tcfg)
    assert type(tloss).__name__ == name
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), train=False)))(params)

    def port(dtype):
        p = {k: v.detach().to(dtype).requires_grad_(True)
             for k, v in tmodel.net.named_parameters()}
        value = tloss.calc_loss(tmodel, p, torch.Generator(), torch.from_numpy(x0),
                                train=False)
        return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))

    tl, tg = port(torch.float32)
    _, ref = port(torch.float64)
    assert np.isfinite(float(jl))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads_within_float32(jg, tg, ref, tmodel.net)


def grads_within_float32(jgrads, tgrads, ref, net, convert=hollow_params_from_flax,
                         jax_rel=1e-4):
    """Each port leaf within 4x JAX's largest float32 error of the float64
    gradient `ref`; that error itself within `jax_rel` of the largest |g|."""
    want = convert(jax.tree_util.tree_map(np.asarray, jgrads), net)
    assert set(want) == set(tgrads) == set(ref)
    top = max(g.abs().max().item() for g in ref.values())
    jax_err = max((want[k].double() - ref[k]).abs().max().item() for k in ref)
    assert jax_err <= jax_rel * top, (jax_err, top)
    for k, g in tgrads.items():
        err = (g.double() - ref[k]).abs().max().item()
        assert err <= 4 * jax_err, (k, err, jax_err)


def test_times_clamp_below_one():
    """`_sample_ts(..., clamp_hi=0.99999)`: no time reaches 1."""
    ts_ = TL._sample_ts(torch.Generator().manual_seed(0), 4096, 0.5, 1.0, clamp_hi=0.99999)
    assert float(ts_.max()) <= 0.99999 and float(ts_.min()) >= 0.5


def gumbels(keys, shape):
    return [np.array(jax.random.gumbel(k, shape)) for k in keys]


@pytest.mark.parametrize("name,kind,log_prob", [
    ("CRMebmLBJF", "BinaryTransformerScoreFunc", "bin_ebm"),
    ("ExactSampling", "BinaryTransformerScoreFunc", "bin_ebm"),
    ("CRMebmLBJF", "CatMLPScoreFunc", "ebm"),
])
def test_ebm_sampling_matches_jax(name, kind, log_prob):
    """The whole JAX run (its `sample`) against the port's steps on the same
    noise: LBJF splits each step's key into (categorical, corrector);
    ExactSampling draws from the step's key. `model.log_prob` "bin_ebm"
    takes the bit-flip logits, "ebm" the all-mutation logits (S=3)."""
    cfg, tcfg, jmodel, params, tmodel = models(kind)
    for c in (cfg, tcfg):
        c.sampler.name, c.model.log_prob = name, log_prob
    N, S = 4, NETS[kind]
    key = jax.random.PRNGKey(7)
    jsampler, sampler = js.get_sampler(cfg), ts.get_sampler(tcfg)
    assert sampler.log_prob_kind == log_prob and not sampler._fused_applicable()
    want, _ = jsampler.sample(jmodel, params, key, N=N)
    k_init, k_scan = jax.random.split(key)
    x = torch.from_numpy(np.array(jax.random.randint(k_init, (N, D), 0, S), np.int32))
    keys = jax.random.split(k_scan, cfg.sampler.num_steps)
    if name == "CRMebmLBJF":
        keys = [jax.random.split(k)[0] for k in keys]
    pts, phs = sampler.time_grid()
    x_T = x.clone()
    with torch.no_grad():
        for t, h, g in zip(pts, phs, gumbels(keys, (N, D, S))):
            x = sampler.step(tmodel, tmodel.net, x, float(t), float(h), g=torch.from_numpy(g))
    np.testing.assert_array_equal(x.numpy(), want)
    assert (x != x_T).any()  # the chain moved


@pytest.mark.parametrize("name", ["BinEBMAux", "EBMAux"])
def test_ebm_losses_take_injected_draws(name):
    """`calc_loss(ts=, samples=)` equals the drawn path on the same draws."""
    _, tcfg, _, _, tmodel = models("BinaryTransformerScoreFunc")
    tcfg.loss.name = name
    loss = TL.get_loss(tcfg)
    x0 = torch.from_numpy(states(2, n=3, seed=8)[0])
    drawn = loss.calc_loss(tmodel, tmodel.net, torch.Generator().manual_seed(5), x0,
                           train=False)
    gen = torch.Generator().manual_seed(5)
    ts = TL._sample_ts(gen, 3, tcfg.loss.min_time, 1.0, clamp_hi=0.99999)
    xt = TL.sample_xt(gen, tmodel.transition(ts), x0)
    given = loss.calc_loss(tmodel, tmodel.net, None, x0, train=False, ts=ts, samples=(xt,))
    assert torch.equal(drawn, given)


def test_ebm_synthetic_at_full_width_matches_jax(monkeypatch):
    """The preset as it trains (embed 256, 3 layers, D=32) from flax's own
    initial weights: the training data, the bit-flip logits, one BinEBMAux
    value and gradient with injected draws, and ExactSampling's whole
    3-step run on JAX's noise, at batch 2. At this width JAX's own float32
    gradient error is ~4e-4 of the largest |g| (the loss takes differences
    of nearly equal energies), so the guard on it is
    1e-3 here; the port's leaves are held to 4x that error as above."""
    from ctdd_tpu.data import get_dataset as jax_get_dataset
    from ctdd_tpu_torch.data.loaders import get_dataset

    cfg = jax_get_preset("ebm_synthetic")
    with cfg.unlocked():
        cfg.sampler.num_steps = 3
    tcfg = Config(cfg.to_dict())
    np.testing.assert_array_equal(np.asarray(get_dataset(tcfg).data),
                                  np.asarray(jax_get_dataset(cfg).data))
    Dw = cfg.model.concat_dim
    jmodel, tmodel = jax_create_model(cfg), create_model(tcfg, device="cpu")
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((2, Dw), jnp.int32),
                         jnp.full((2,), 0.5))
    tmodel.net.load_state_dict(hollow_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel.net))
    tmodel.net.eval()
    rng = np.random.default_rng(11)
    x0, xt = (rng.integers(0, 2, (2, Dw)).astype(np.int32) for _ in range(2))
    t = np.array([0.05, 0.7], np.float32)
    want = np.asarray(JL.bin_ebm_flip_logits(jmodel, params, jnp.asarray(xt), jnp.asarray(t)))
    with torch.no_grad():
        got = TL.bin_ebm_flip_logits(tmodel, tmodel.net, torch.from_numpy(xt),
                                     torch.from_numpy(t)).numpy()
    close(got, want)

    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    jloss, tloss = JL.BinEBMAux(cfg), TL.get_loss(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), train=False)))(params)

    def port(dtype):
        p = {k: v.detach().to(dtype).requires_grad_(True)
             for k, v in tmodel.net.named_parameters()}
        value = tloss.calc_loss(tmodel, p, None, torch.from_numpy(x0), train=False,
                                ts=torch.from_numpy(t).to(dtype),
                                samples=(torch.from_numpy(xt),))
        return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))

    tl, tg = port(torch.float32)
    _, ref = port(torch.float64)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads_within_float32(jg, tg, ref, tmodel.net, jax_rel=1e-3)

    key = jax.random.PRNGKey(4)
    want, _ = js.get_sampler(cfg).sample(jmodel, params, key, N=2)
    k_init, k_scan = jax.random.split(key)
    x = torch.from_numpy(np.array(jax.random.randint(k_init, (2, Dw), 0, 2), np.int32))
    sampler = ts.get_sampler(tcfg)
    pts, phs = sampler.time_grid()
    with torch.no_grad():
        for tk, hk, g in zip(pts, phs, gumbels(jax.random.split(k_scan, 3), (2, Dw, 2))):
            x = sampler.step(tmodel, tmodel.net, x, float(tk), float(hk), g=torch.from_numpy(g))
    np.testing.assert_array_equal(x.numpy(), want)
