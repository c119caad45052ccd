"""Port vs JAX: the rest of the samplers — PCTauL (with a live corrector),
TAULStepSize (its traces), ExactSampling and `lbjf_corrector_step` — on the
tiny flagship UNet (8x8, S=8) with the flax weights carried across; the
oracle-convergence cases of tests/test_sampler_convergence.py for the new
samplers; the two new presets.

Each JAX sampler runs whole (`sample`) from one key. The port's steps take
the same noise, rebuilt from JAX's key schedule: x_T from
`get_initial_samples` on the init key; a Poisson step's uniforms are
`jax.random.uniform` of its key and a categorical draw adds
`jax.random.gumbel` of its key (what `jax.random.categorical` does).
States equal; TAULStepSize's traces equal to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch import registry
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import DiffusionModel
from ctdd_tpu_torch.ops.forward_process import make_uniform
from ctdd_tpu_torch.sampling import samplers as ts
from test_torch_lbjf import MILD, _cfgs, _models
from test_torch_sampler import OracleNet
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

N = 4
STEPS = 6


def split_keys(key, n):
    """JAX's schedule: (init key, the n per-step keys)."""
    k_init, k_scan = jax.random.split(key)
    return k_init, jax.random.split(k_scan, n)


def x_T(cfg, k_init, D=None):
    x = js.get_initial_samples(k_init, N, D or cfg.model.concat_dim, cfg.data.S,
                               cfg.sampler.initial_dist, 200.0
                               if cfg.sampler.name == "PCTauL" else cfg.model.Q_sigma)
    return torch.from_numpy(np.array(x, np.int32))


def uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def gumbel(key, shape):
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape)))


def corrector_keys(k_corr, n):
    """The fori_loop's keys: kc, ku = split(kc) per corrector step."""
    out = []
    for _ in range(n):
        k_corr, ku = jax.random.split(k_corr)
        out.append(ku)
    return out


def setup(name, **sampler_kw):
    cfg, tcfg = _cfgs("flagship", name, num_steps=STEPS, model_kw=MILD, **sampler_kw)
    jmodel, params, tmodel = _models(cfg, tcfg)
    return cfg, tcfg, jmodel, params, tmodel, js.get_sampler(cfg), ts.get_sampler(tcfg)


def test_pctaul_with_live_corrector_matches_jax():
    """PCTauL's own grid (num_steps - 1 steps), the p0t predictor, two
    corrector steps at t - h with 1.5 h below the entry time, the denoise."""
    grid, _ = ts._pc_time_grid(0.01, STEPS)
    cfg, tcfg, jmodel, params, tmodel, jsampler, sampler = setup(
        "PCTauL", num_corrector_steps=2, corrector_entry_time=float(grid[2]))
    assert type(sampler) is ts.PCTauL and sampler.initial_dist_std == 200.0
    pts, phs = sampler.time_grid()
    assert len(pts) == STEPS - 1
    key = jax.random.PRNGKey(3)
    want, _ = jsampler.sample(jmodel, params, key, N=N)
    k_init, keys = split_keys(key, STEPS - 1)
    x = x_T(cfg, k_init)
    x_start, shape = x.clone(), (N, cfg.model.concat_dim, cfg.data.S)
    corrected = 0
    with torch.no_grad():
        for t, h, k in zip(pts, phs, keys):
            k_pred, k_corr = jax.random.split(k)
            x = sampler.step(tmodel, tmodel.net, x, float(t), float(h), u=uniform(k_pred, shape))
            if t <= np.float32(tcfg.sampler.corrector_entry_time):
                for ku in corrector_keys(k_corr, 2):
                    x = sampler.corrector_step(tmodel, tmodel.net, x, float(t), float(h),
                                               u=uniform(ku, shape))
                    corrected += 1
        x = ts._denoise_argmax(tmodel, tmodel.net, x, tcfg.sampler.min_t, N)
    assert corrected == 2 * 3  # the grid's steps 2, 3 and 4
    assert (x != x_start).float().mean() > 0.05
    np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("corrector", [False, True])
def test_taul_step_size_traces_match_jax(corrector):
    kw = dict(num_corrector_steps=1, corrector_entry_time=0.5) if corrector else {}
    cfg, tcfg, jmodel, params, tmodel, jsampler, sampler = setup("TAULStepSize", **kw)
    key = jax.random.PRNGKey(5)
    want, jdiags = jsampler.sample(jmodel, params, key, N=N)
    k_init, keys = split_keys(key, STEPS)
    x = x_T(cfg, k_init)
    shape = (N, cfg.model.concat_dim, cfg.data.S)
    pts, phs = sampler.time_grid()
    traces = []
    with torch.no_grad():
        for t, h, k in zip(pts, phs, keys):
            k_jump, k_corr = jax.random.split(k)
            tr = {}
            x = sampler.step(tmodel, tmodel.net, x, float(t), float(h),
                             u=uniform(k_jump, shape), traces=tr)
            traces.append(tr)
            if corrector and t <= np.float32(0.5):
                x = sampler.corrector_step(tmodel, tmodel.net, x, float(t), float(h),
                                           u=uniform(corrector_keys(k_corr, 1)[0], shape))
        x = ts._denoise_argmax(tmodel, tmodel.net, x, tcfg.sampler.min_t, N)
    np.testing.assert_array_equal(x.numpy(), want)
    for name in ("frac_jumped", "frac_multi", "frac_clipped"):
        got = np.array([float(tr[name]) for tr in traces])
        np.testing.assert_allclose(got, np.asarray(jdiags[name]), rtol=1e-6)
    assert np.sum(jdiags["frac_jumped"]) > 0


def test_taul_step_size_sample_returns_traces():
    """`sample` returns the three traces as (num_steps,) arrays, finite, with
    frac_clipped <= frac_jumped step by step."""
    _, _, _, _, tmodel, _, sampler = setup("TAULStepSize")
    x, traces = sampler.sample(tmodel, tmodel.net, torch.Generator().manual_seed(0), N)
    assert x.shape == (N, 64) and set(traces) == {"frac_jumped", "frac_multi", "frac_clipped"}
    for v in traces.values():
        assert v.shape == (STEPS,) and np.isfinite(v).all()
    assert (traces["frac_clipped"] <= traces["frac_jumped"]).all()


def test_exact_sampling_matches_jax():
    """The bridge step (with its 1/q_{t|0} denominator) and a Gumbel-max
    draw from each step's key; no denoise."""
    cfg, tcfg, jmodel, params, tmodel, jsampler, sampler = setup("ExactSampling")
    key = jax.random.PRNGKey(9)
    want, jchanges = jsampler.sample(jmodel, params, key, N=N)
    k_init, keys = split_keys(key, STEPS)
    x = x_T(cfg, k_init)
    x_start, shape = x.clone(), (N, cfg.model.concat_dim, cfg.data.S)
    pts, phs = sampler.time_grid()
    with torch.no_grad():
        for t, h, k in zip(pts, phs, keys):
            x = sampler.step(tmodel, tmodel.net, x, float(t), float(h), g=gumbel(k, shape))
    assert (x != x_start).float().mean() > 0.05
    np.testing.assert_array_equal(x.numpy(), want)
    # its change counts are per dim, as JAX's
    _, changes = sampler.sample(tmodel, tmodel.net, torch.Generator().manual_seed(0), N)
    assert changes.shape == (STEPS,) and (changes <= 1).all()
    assert np.asarray(jchanges).shape == (STEPS,)


@pytest.mark.parametrize("logit_type", ["direct", "reverse_prob"])
def test_lbjf_corrector_step_matches_jax(logit_type):
    """The standalone corrector with a target state other than x_t: the
    posterior one-hot at xt_target, through the posterior kernel's plain
    version."""
    cfg, tcfg, jmodel, params, tmodel, _, _ = setup("LBJF")
    for c in (cfg, tcfg):
        c.loss.logit_type = logit_type
    rng = np.random.default_rng(11)
    D, S = cfg.model.concat_dim, cfg.data.S
    xt = rng.integers(0, S, (N, D)).astype(np.int32)
    target = np.where(rng.random((N, D)) < 0.5, rng.integers(0, S, (N, D)), xt).astype(np.int32)
    assert (target != xt).mean() > 0.3
    key = jax.random.PRNGKey(13)
    t, h = np.float32(0.4), np.float32(0.05)
    want = js.lbjf_corrector_step(cfg, jmodel, params, key, jnp.asarray(xt), t, h, N,
                                  xt_target=jnp.asarray(target))
    with torch.no_grad():
        got = ts.lbjf_corrector_step(tcfg, tmodel, tmodel.net, None, torch.from_numpy(xt),
                                     float(t), float(h), N,
                                     xt_target=torch.from_numpy(target),
                                     g=gumbel(key, (N, D, S)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and without a target it steps from x_t
    with torch.no_grad():
        same = ts.lbjf_corrector_step(tcfg, tmodel, tmodel.net, None, torch.from_numpy(xt),
                                      float(t), float(h), N, g=gumbel(key, (N, D, S)))
    want_same = js.lbjf_corrector_step(cfg, jmodel, params, key, jnp.asarray(xt), t, h, N)
    np.testing.assert_array_equal(same.numpy(), np.asarray(want_same))


# -- oracle convergence (tests/test_sampler_convergence.py, the new samplers) --

def oracle_cfg(loss_name, sampler_name, S=4, D=6, steps=100):
    cfg = get_preset("mlp_synthetic")
    cfg.data.S, cfg.data.shape, cfg.model.concat_dim = S, [D], D
    cfg.model.rate_const = 1.5
    cfg.loss.name, cfg.loss.logit_type = loss_name, "direct"
    cfg.sampler.name, cfg.sampler.num_steps = sampler_name, steps
    cfg.sampler.min_t = cfg.loss.min_time = 0.01
    cfg.sampler.is_ordinal = True
    return cfg


@pytest.mark.parametrize("sampler_name,loss_name,corrector", [
    ("PCTauL", "CTElbo", False),
    ("ExactSampling", "CatRM", False),
    ("TAULStepSize", "CTElbo", False),
    ("PCTauL", "CTElbo", True),
    ("TAULStepSize", "CTElbo", True),
])
def test_oracle_converges_to_class_zero(sampler_name, loss_name, corrector):
    cfg = oracle_cfg(loss_name, sampler_name)
    if corrector:
        cfg.sampler.corrector_entry_time, cfg.sampler.num_corrector_steps = 0.5, 3
    model = DiffusionModel(net=OracleNet(4), process=make_uniform(4, 1.5, device="cpu"),
                           cfg=cfg)
    sampler = ts.get_sampler(cfg)
    assert sampler.num_corrector_steps == (3 if corrector else 0)
    samples, _ = sampler.sample(model, model.net, torch.Generator().manual_seed(0), 32)
    assert np.mean(samples == 0) > 0.9, (sampler_name, np.mean(samples == 0))


@pytest.mark.parametrize("sampler_name", ["ConditionalTauLeaping", "ConditionalPCTauLeaping",
                                          "ConditionalLBJF"])
def test_conditional_oracle_converges(sampler_name):
    """The conditional samplers keep the prefix and drive the suffix to the
    oracle's class."""
    cfg = oracle_cfg("NLLOriginal", sampler_name, D=8)
    cfg.sampler.condition_dim = 3
    if sampler_name == "ConditionalPCTauLeaping":
        cfg.sampler.corrector_entry_time, cfg.sampler.num_corrector_steps = 0.5, 2
    model = DiffusionModel(net=OracleNet(4), process=make_uniform(4, 1.5, device="cpu"),
                           cfg=cfg)
    cond = np.random.default_rng(0).integers(1, 4, (32, 3))
    samples = ts.get_sampler(cfg).sample(model, model.net, torch.Generator().manual_seed(0),
                                         32, conditioner=cond)
    assert samples.shape == (32, 8)
    np.testing.assert_array_equal(samples[:, :3], cond)
    assert np.mean(samples[:, 3:] == 0) > 0.9


# -- registry and presets ----------------------------------------------------

@pytest.mark.parametrize("name", ["PCTauL", "TAULStepSize", "ExactSampling",
                                  "ConditionalTauLeaping", "ConditionalPCTauLeaping",
                                  "ConditionalLBJF", "ElboTauL", "TauLeaping", "CRMLBJF",
                                  "LBJFSampling", "CRMebmLBJF"])
def test_samplers_resolve_as_in_jax(name):
    from ctdd_tpu import registry as jregistry

    assert registry.samplers.get(name).__name__ == jregistry.samplers.get(name).__name__


def test_the_port_has_twenty_presets():
    """The eighteen of slices 1-7 and this slice's two; every one is a JAX
    preset."""
    from ctdd_tpu.config.presets import preset_names as jax_preset_names
    from ctdd_tpu_torch.config.presets import preset_names
    from test_torch_maze_presets import EARLIER, HOLLOW, NEW

    assert sorted(preset_names()) == sorted(NEW + HOLLOW + EARLIER
                                            + ["ebm_synthetic", "pianoroll_cond"])
    assert set(preset_names()) <= set(jax_preset_names())


@pytest.mark.parametrize("preset", ["ebm_synthetic", "pianoroll_cond"])
def test_new_presets_equal_jax(preset):
    tcfg = get_preset(preset)
    assert tcfg.to_dict() == jax_get_preset(preset).to_dict()
    sampler = ts.get_sampler(Config(tcfg.to_dict()))
    assert type(sampler).__name__ == tcfg.sampler.name
