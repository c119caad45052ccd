"""Port vs JAX: the prefix-conditional path — CondCTElbo and CondNLL (with
the key head), the three conditional samplers (with and without
`noise_prefix`), the pianoroll stand-in and its metrics, `cond_mmd` through
the eval CLI, and `PrefixConditionalBidirTransformer`.

The sequence transformer at the tiny width of test_torch_sequence_transformer
(L=10, S=7, a 3-token prefix), flax leaves redrawn from seeded normals.
Losses: draws injected on both sides by patching `_sample_ts` and
`sample_xt_xtilde` in both loss modules; the loss to rtol 1e-5; the
gradients as test_torch_ebm holds them, to a float64 gradient of the same
loss (the port's net and tables in float64): each leaf within 4x JAX's own
largest float32 error there (under qk_norm some leaves' gradients are ~1e-9
of the net's, so a per-leaf relative bound would hold rounding noise).
Samplers: the JAX sampler's whole run from one key; the port's steps take
the same noise rebuilt from JAX's key schedule (x_T, `jax.random.uniform`
for Poisson steps, `jax.random.gumbel` for categorical draws, the prefix
draws too): states equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.data import pianoroll as JP
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.metrics.mmd import categorical_exp_hamming_mmd as jax_cat_mmd
from ctdd_tpu.networks import hollow as jhollow
from ctdd_tpu.config.base import FrozenCfg
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch import eval as eval_cli
from ctdd_tpu_torch.convert import hollow_params_from_flax, sequence_transformer_params_from_flax
from ctdd_tpu_torch.data import pianoroll as TP
from ctdd_tpu_torch.data.loaders import get_dataset
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.networks import hollow as thollow
from ctdd_tpu_torch.sampling import samplers as ts
from test_torch_ebm import grads_within_float32
from test_torch_hollow import tiny_cfgs
from test_torch_sequence_transformer import L, S, port, seeded, seq_cfgs
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

P = 3  # the prefix
N = 4


def pair(seed=1, **model):
    cfg, tcfg = seq_cfgs(**model)
    for c in (cfg, tcfg):
        c.model.rate_const = 1.0  # the chains move within a few steps
        c.sampler.num_steps = 6
    jmodel, params = seeded(cfg, seed=seed, scale=0.3)
    return cfg, tcfg, jmodel, params, port(tcfg, params)


class Float64Tables:
    """The model with its process tables in float64 (a float64 reference)."""

    def __init__(self, model):
        self.m = model

    def __getattr__(self, name):
        return getattr(self.m, name)

    def transition(self, t):
        return self.m.transition(t).double()

    def rate(self, t):
        return self.m.rate(t).double()


LOSSES = {
    "CondCTElbo": dict(name="CondCTElbo", nll_weight=0.3),
    "CondCTElbo_two_states": dict(name="CondCTElbo", nll_weight=0.3, one_forward_pass=False),
    "CondNLL": dict(name="CondNLL"),
    "CondNLL_key_head": dict(name="CondNLL", aux_key_weight=0.5),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_conditional_losses_match_jax_with_injected_samples(case, monkeypatch):
    kw = LOSSES[case]
    cfg, tcfg, jmodel, params, tmodel = pair(
        aux_key_classes=12 if "aux_key_weight" in kw else 0)
    for c in (cfg, tcfg):
        for k, v in kw.items():
            c.loss[k] = v
    # prefixes of stand-in notes, so the key labels vary
    x0 = TP.generate_standin(3, length=L, seed=5, beat=1) % S
    ts_ = np.array([0.05, 0.4, 0.8], np.float32)
    t = torch.from_numpy(ts_)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(2), tmodel.transition(t),
                                  tmodel.rate(t), torch.from_numpy(x0[:, P:]))
    xt, xtl = xt.numpy(), xtl.numpy()
    assert (xt != xtl).any()
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(ts_))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(ts_))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    jloss, tloss = getattr(JL, kw["name"])(cfg), TL.get_loss(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), train=False)))(params)

    def port(dtype, model):
        p = {k: v.detach().to(dtype).requires_grad_(True)
             for k, v in tmodel.net.named_parameters()}
        value = tloss.calc_loss(model, p, torch.Generator(), torch.from_numpy(x0),
                                train=False)
        return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))

    tl, tg = port(torch.float32, tmodel)
    _, ref = port(torch.float64, Float64Tables(tmodel))
    assert np.isfinite(float(jl))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads_within_float32(jg, tg, ref, tmodel.net, sequence_transformer_params_from_flax)


def test_cond_nll_key_head_needs_the_head():
    _, tcfg = seq_cfgs()
    tcfg.loss.name, tcfg.loss.aux_key_weight = "CondNLL", 0.5
    with pytest.raises(ValueError, match="aux_key_classes"):
        TL.get_loss(tcfg)


def _gumbel(key, shape):
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape)))


def _uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


CASES = {
    "ConditionalTauLeaping": ("ConditionalTauLeaping", {}),
    "ConditionalTauLeaping_noise_prefix": ("ConditionalTauLeaping", dict(noise_prefix=True)),
    "ConditionalTauLeaping_multi_jumps": ("ConditionalTauLeaping",
                                          dict(reject_multiple_jumps=False)),
    "ConditionalLBJF": ("ConditionalLBJF", {}),
    "ConditionalLBJF_noise_prefix": ("ConditionalLBJF", dict(noise_prefix=True)),
    "ConditionalPCTauLeaping_corrector": ("ConditionalPCTauLeaping",
                                          dict(num_corrector_steps=2, corrector_entry_time=0.7,
                                               noise_prefix=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conditional_samplers_match_jax(case):
    name, kw = CASES[case]
    cfg, tcfg, jmodel, params, tmodel = pair()
    for c in (cfg, tcfg):
        c.sampler.name = name
        for k, v in kw.items():
            c.sampler[k] = v
    jsampler, sampler = js.get_sampler(cfg), ts.get_sampler(tcfg)
    assert type(sampler).__name__ == name
    cond = TP.generate_standin(N, length=P, seed=1, beat=1) % S
    key = jax.random.PRNGKey(21)
    want = jsampler.sample(jmodel, params, key, N=N, conditioner=cond)
    sD = L - P
    k_init, k_scan = jax.random.split(key)
    x = torch.from_numpy(np.array(js.get_initial_samples(
        k_init, N, sD, S, cfg.sampler.initial_dist, None), np.int32))
    x_start = x.clone()
    pts, phs = sampler.time_grid()
    keys = jax.random.split(k_scan, len(pts))
    tcond = torch.from_numpy(cond.astype(np.int32))
    shape = (N, sD, S)
    noised = corrected = 0
    with torch.no_grad():
        for t, h, k in zip(pts, phs, keys):
            t, h = float(t), float(h)
            if name == "ConditionalPCTauLeaping":  # noise_prefix ignored, as in JAX
                k_pred, k_corr = jax.random.split(k)
                x = sampler.step(tmodel, tmodel.net, tcond, x, t, h, u=_uniform(k_pred, shape))
                if np.float32(t) <= np.float32(0.7):
                    for _ in range(2):
                        k_corr, ku = jax.random.split(k_corr)
                        x = sampler.corrector_step(tmodel, tmodel.net, tcond, x, t, h,
                                                   u=_uniform(ku, shape))
                        corrected += 1
                continue
            step_cond = tcond
            if kw.get("noise_prefix"):
                k, k_pre = jax.random.split(k)
                step_cond = sampler._step_conditioner(tmodel, None, tcond, t,
                                                      g=_gumbel(k_pre, (N, P, S)))
                noised += int((step_cond != tcond).any())
            noise = {"g": _gumbel(k, shape)} if name == "ConditionalLBJF" else \
                {"u": _uniform(k, shape)}
            x = sampler.step(tmodel, tmodel.net, step_cond, x, t, h, **noise)
        x0max = torch.argmax(sampler._cond_logits(tmodel, tmodel.net, tcond, x, sampler.min_t),
                             dim=-1)
    got = np.concatenate([cond, x0max.numpy()], axis=1)
    assert got.shape == want.shape == (N, L)
    np.testing.assert_array_equal(got, want)
    assert (x != x_start).any()
    if kw.get("noise_prefix") and name != "ConditionalPCTauLeaping":
        assert noised > 0
    if name == "ConditionalPCTauLeaping":
        assert corrected > 0
    # the port's own sample() returns [conditioner | suffix]
    full = sampler.sample(tmodel, tmodel.net, torch.Generator().manual_seed(0), N,
                          conditioner=cond)
    assert full.shape == (N, L)
    np.testing.assert_array_equal(full[:, :P], cond)


def test_noise_prefix_off_draws_nothing_extra():
    """Without `noise_prefix` a step takes no prefix draw: the generator's
    stream is the one a run without the flag in the config sees."""
    _, tcfg, _, _, tmodel = pair()
    cond = np.zeros((N, P), np.int64)
    outs = []
    for flag in (None, False):
        if flag is not None:
            tcfg.sampler.noise_prefix = flag
        outs.append(ts.get_sampler(tcfg).sample(
            tmodel, tmodel.net, torch.Generator().manual_seed(4), N, conditioner=cond))
    np.testing.assert_array_equal(*outs)
    tcfg.sampler.noise_prefix = True
    noisy = ts.get_sampler(tcfg).sample(tmodel, tmodel.net, torch.Generator().manual_seed(4),
                                        N, conditioner=cond)
    np.testing.assert_array_equal(noisy[:, :P], cond)  # the returned prefix stays clean


def test_conditional_sampler_needs_a_conditioner():
    _, tcfg, _, _, tmodel = pair()
    with pytest.raises(ValueError, match="conditioner"):
        ts.get_sampler(tcfg).sample(tmodel, tmodel.net, torch.Generator(), N)


# -- the pianoroll stand-in and its metrics -----------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_standin_equals_jax(seed):
    got = TP.generate_standin(40, length=64, seed=seed)
    want = JP.generate_standin(40, length=64, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.max() <= TP.REST


def test_key_inference_and_scale_consistency_equal_jax():
    seqs = JP.generate_standin(60, length=96, seed=3)
    rng = np.random.default_rng(0)
    noisy = np.where(rng.random(seqs.shape) < 0.3, rng.integers(0, 129, seqs.shape), seqs)
    for arr in (seqs, noisy):
        np.testing.assert_array_equal(TP.infer_key(arr[:, :32]), JP.infer_key(arr[:, :32]))
        np.testing.assert_array_equal(
            TP.infer_key_torch(torch.from_numpy(arr[:, :32])).numpy(),
            np.asarray(JP.infer_key_jnp(jnp.asarray(arr[:, :32]))))
        assert TP.scale_consistency(arr, 32) == JP.scale_consistency(arr, 32)
    np.testing.assert_array_equal(TP.scale_membership(), JP.scale_membership())
    assert TP.scale_consistency(seqs, 32) > 0.9
    rests = np.full((3, 40), TP.REST)
    assert np.isnan(TP.scale_consistency(rests, 8))


def test_lakh_dataset_falls_back_to_the_standin(tmp_path):
    from ctdd_tpu.data.images import lakh_pianoroll as jax_lakh
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset("pianoroll_cond")
    cfg.data.location = str(tmp_path / "absent.npy")
    cfg.data.num_samples = 50
    got = get_dataset(cfg)
    assert got.data.shape == (50, 256) and got.data.dtype == np.int32
    np.testing.assert_array_equal(got.data, jax_lakh(cfg).data)
    np.save(tmp_path / "real.npy", got.data[:7].astype(np.int64))
    cfg.data.location = str(tmp_path / "real.npy")
    assert get_dataset(cfg).data.shape == (7, 256)


# -- cond_mmd through the eval CLI --------------------------------------------

TINY_SEQ = ["model.num_layers=1", "model.d_model=8", "model.num_heads=2",
            "model.dim_feedforward=12", "model.temb_dim=4", "data.num_samples=60",
            "sampler.num_steps=3"]


@pytest.mark.parametrize("sampler", ["ConditionalTauLeaping", "ConditionalLBJF"])
def test_cond_mmd_through_the_eval_cli(tmp_path, capsys, sampler):
    """A tiny pianoroll_cond checkpoint scored by `--metric cond_mmd`: the
    floor and the shuffled anchor equal the JAX package's MMD of the same
    arrays, the model's MMD is finite, and the pianoroll line's ground-truth
    numbers equal the JAX package's."""
    from test_torch_eval import _checkpoint, _run

    over = TINY_SEQ + [f"sampler.name={sampler}", f"data.location={tmp_path}/absent.npy"]
    ckpt = _checkpoint(tmp_path, "pianoroll_cond", over, step=2)
    res = _run(["--preset", "pianoroll_cond", "--ckpt", ckpt, "--metric", "cond_mmd",
                "--samples", "8", "--batch", "4", "--seed", "3", "--set", *over], capsys)
    assert res["metric"] == "cond_mmd" and res["sampler"] == sampler
    assert np.isfinite(res["value"]) and res["n_samples"] == 8
    assert res["kernel_launches"] == {"fused_tau_leap_update": 0, "reverse_rates": 0,
                                      "euler_posterior": 0}  # plain versions on the CPU
    data = JP.generate_standin(60, length=256, seed=0)
    rng = np.random.RandomState(3)
    idx = rng.choice(60, size=24, replace=False)
    gt_a, gt_b, gt_c = data[idx[:8]], data[idx[8:16]], data[idx[16:]]
    shuffled = gt_a.copy()
    shuffled[:, 32:] = gt_a[rng.permutation(8), 32:]
    d_med = np.median((gt_b[:, None, :] != gt_c[None, :, :]).sum(axis=-1))
    bd = float(np.log(2.0) / max(d_med, 1.0))
    assert res["bandwidth"] == pytest.approx(bd)
    for k, arr in (("floor", gt_c), ("shuffled", shuffled)):
        want = float(jax_cat_mmd(jnp.asarray(arr), jnp.asarray(gt_b), bd))
        assert res[k] == pytest.approx(want, abs=1e-6), k
    assert res["gt_scale_consistency"] == JP.scale_consistency(gt_b, 32)
    assert res["shuffled_scale_consistency"] == JP.scale_consistency(shuffled, 32)
    assert 0.0 <= res["model_rest_frac"] <= 1.0
    assert json.dumps(res)


def test_cond_mmd_needs_three_sample_sets(tmp_path):
    from test_torch_eval import _checkpoint

    over = TINY_SEQ + [f"data.location={tmp_path}/absent.npy"]
    ckpt = _checkpoint(tmp_path, "pianoroll_cond", over, step=2)
    with pytest.raises(SystemExit, match="3\\*samples"):
        eval_cli.main(["--preset", "pianoroll_cond", "--ckpt", ckpt, "--metric", "cond_mmd",
                       "--samples", "30", "--device", "cpu", "--set", *over])


# -- PrefixConditionalBidirTransformer ----------------------------------------

@pytest.mark.parametrize("readout", ["attention", "res_concat", "concat"])
def test_prefix_conditional_bidir_transformer_matches_jax(readout):
    D, Sh, cond_dim = 5, 4, 2
    cfg, tcfg = tiny_cfgs("hollow_synthetic", bidir_readout=readout, nets="bidir_transformer",
                          conditional_dim=cond_dim)
    jnet = jhollow.PrefixConditionalBidirTransformer(cfg=FrozenCfg(cfg))
    x = np.random.default_rng(2).integers(0, Sh, (3, D)).astype(np.int32)
    t = np.array([0.05, 0.5, 0.9], np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(t))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    net = thollow.PrefixConditionalBidirTransformer(tcfg)
    net.load_state_dict(hollow_params_from_flax(params, net))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3, D, Sh)
    assert (got[:, :cond_dim] == 0).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("name", ["CondCTElbo", "CondNLL"])
def test_conditional_losses_take_injected_draws(name):
    """`calc_loss(ts=, samples=)` (the injection point chip_smoke.py's card
    check uses) equals the drawn path on the same draws."""
    _, tcfg, _, _, tmodel = pair()
    tcfg.loss.name = name
    loss = TL.get_loss(tcfg)
    x0 = torch.from_numpy(TP.generate_standin(3, length=L, seed=2, beat=1) % S)
    drawn = loss.calc_loss(tmodel, tmodel.net, torch.Generator().manual_seed(5), x0,
                           train=False)
    gen = torch.Generator().manual_seed(5)
    ts = TL._sample_ts(gen, 3, tcfg.loss.min_time, 1.0)
    draws = TL.sample_xt_xtilde(gen, tmodel.transition(ts), tmodel.rate(ts), x0[:, P:])
    given = loss.calc_loss(tmodel, tmodel.net, None, x0, train=False, ts=ts, samples=draws)
    assert torch.equal(drawn, given)


@pytest.mark.parametrize("rows", [40, 10])
def test_train_loop_grid_takes_training_prefixes(tmp_path, rows):
    """The in-loop grid of a prefix-conditional sampler conditions on the
    first 16 training prefixes (a .npy of [prefix | suffix]); a dataset of
    fewer rows skips the grid, as the JAX loop does."""
    from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
    from ctdd_tpu_torch.training.loop import train

    cfg = apply_overrides(get_preset("pianoroll_cond"), parse_overrides(
        TINY_SEQ + [f"data.num_samples={rows}", "data.batch_size=4", "sampler.sample_freq=2",
                    f"data.location={tmp_path}/absent.npy", f"save_location={tmp_path}/runs"]))
    _, info = train(cfg, n_iters=2, device="cpu", log_every=2)
    grid = list((tmp_path / "runs").rglob("samples_2.npy"))
    if rows < 16:
        assert grid == []
        return
    samples = np.load(grid[0])
    assert samples.shape == (16, 256)
    np.testing.assert_array_equal(samples[:, :32], TP.generate_standin(16, 256)[:, :32])
