"""Port vs JAX: the LBJF, corrector and MidPointTauL sampler paths.

- K steps from the same x_T with the same injected noise (Gumbel draws for
  the Euler updates, uniforms for the Poisson ones): states equal. The JAX
  side is held to `argmax(euler_posterior_xla(...) + g)`, the Gumbel-max form
  of `jax.random.categorical`.
- Whole-sampler statistics against the JAX samplers: total-variation distance
  of the final-state histograms below 0.05 (their sampling noise is about
  0.01), and the summed per-step change counts within the stated share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.ops import fused_update as jfu
from ctdd_tpu.ops import indexing as jidx
from ctdd_tpu.ops import pallas_kernels as pk
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch import registry
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.sampling import samplers as ts
from tests.test_torch_unet import (  # noqa: F401
    flagship_cfgs, one_torch_thread, port_net, seeded_flax_params,
)

K = 5


MILD = {"time_base": 0.5, "time_exp": 10.0}


def _cfgs(config: str, sampler: str, num_steps: int = 50, model_kw=None,
          **sampler_kw):
    """(JAX cfg, port cfg): the tiny flagship, or tauUnet_maze cut to a 7x7
    board and a narrow UNet (S=3, padded, UniformVariantRate as shipped).

    The flagship's rate schedule is made for 1000 steps: on a 50-step grid
    h * sum(rates) >= 1 in every row of every step, so the Euler posterior
    always has diag = 0 and every dim moves every step. `model_kw=MILD`
    slows the schedule so that a 50-step chain stays below that."""
    if config == "flagship":
        cfg, _ = flagship_cfgs("tiny")
    else:
        cfg = jax_get_preset("tauUnet_maze")
        cfg.data.image_size = cfg.model.image_size = 7
        cfg.data.shape = [1, 7, 7]
        cfg.model.concat_dim = 49
        cfg.model.ch = cfg.model.time_embed_dim = 8
        cfg.model.num_res_blocks = 1
        cfg.model.ch_mult = [1, 2]
        cfg.model.num_heads = 2
        cfg.model.attn_resolutions = [4]
    for k, v in (model_kw or {}).items():
        cfg.model[k] = v
    cfg.sampler.name = sampler
    cfg.sampler.num_steps = num_steps
    for k, v in sampler_kw.items():
        cfg.sampler[k] = v
    return cfg, Config(cfg.to_dict())


def _models(cfg, tcfg, seed=3):
    jmodel, params = seeded_flax_params(cfg, seed=seed, scale=0.15)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(port_net(tcfg, params).state_dict())
    tmodel.net.eval()
    return jmodel, params, tmodel


class _JaxSteps:
    """The JAX package's per-step arithmetic with the noise passed in."""

    def __init__(self, cfg, jmodel, params):
        self.cfg, self.m, self.p = cfg, jmodel, params
        self.S, self.eps = cfg.data.S, cfg.sampler.eps_ratio

    def logits(self, x, t):
        return self.m.apply(self.p, x, t * jnp.ones((x.shape[0],), jnp.float32))

    def rev(self, x, t):
        return js.reverse_rates_shared(
            self.m.process, self.logits(x, t), x, t, rate_param="p0t",
            logit_type="direct", eps=self.eps)

    def corrector_rates(self, x, t):
        _, rate = js._shared_mats(self.m.process, t)
        return jidx.zero_at(self.rev(x, t) + jnp.take(rate, x, axis=0), x)

    def euler(self, x, rates, h, g):
        return jnp.argmax(pk.euler_posterior_xla(rates, x, h) + g, axis=-1)

    def poisson(self, x, rates, h, u):
        n = jfu._poisson_inversion_from_u(u, rates * h)
        diff = (jnp.arange(self.S)[None, None, :] - x[:, :, None]).astype(jnp.float32)
        return jnp.clip(x + jnp.sum(n * diff, axis=-1).astype(jnp.int32), 0, self.S - 1)

    def lbjf(self, x, t, h, g):
        return self.euler(x, self.rev(x, t), h, g)

    def lbjf_corrector(self, x, t, h, g):
        return self.euler(x, self.corrector_rates(x, t), h, g)

    def taul(self, x, t, h, u):
        return self.poisson(x, self.rev(x, t) * jidx.onehot_mask(x, self.S), h, u)

    def taul_corrector(self, x, t, h, u):
        return self.poisson(x, self.corrector_rates(x, t), h, u)

    def midpoint(self, x, t, h, u, fused):
        S = self.S
        t_05 = (t * jnp.ones((1,), jnp.float32) - 0.5 * h)[0]
        if fused:
            qt0, rate = js._shared_mats(self.m.process, t)
            xp = jfu.fused_tau_leap_update_xla(
                self.logits(x, t), x, x, qt0, rate, 0.5 * h, self.eps,
                mode="expected")
            qt0, rate = js._shared_mats(self.m.process, t_05)
            return jfu.fused_tau_leap_update_xla(
                self.logits(xp, t_05), xp, x, qt0, rate, h, self.eps, u=u,
                mode="poisson")
        iota = jnp.arange(S, dtype=jnp.float32)[None, None, :]
        rev = jidx.zero_at(self.rev(x, t), x)
        change = jnp.round(0.5 * h * jnp.sum(
            rev * (iota - x[:, :, None].astype(jnp.float32)), axis=-1)).astype(jnp.int32)
        xp = jnp.clip(x + change, 0, S - 1)
        rev_p = jidx.zero_at(self.rev(xp, t_05), xp)
        flips = jfu._poisson_inversion_from_u(u, rev_p * h)
        off = jnp.sum(flips * (iota - xp[:, :, None].astype(jnp.float32)),
                      axis=-1).astype(jnp.int32)
        return jnp.clip(x + off, 0, S - 1)


def _x_T(rng, cfg, N=4):
    return rng.integers(0, cfg.data.S, (N, cfg.model.concat_dim)).astype(np.int32)


def _noise(rng, kind, shape):
    if kind == "g":
        return rng.gumbel(size=shape).astype(np.float32)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("config", ["flagship", "maze"])
def test_k_lbjf_steps_match_jax(config):
    cfg, tcfg = _cfgs(config, "LBJF", model_kw=MILD if config == "flagship" else None)
    jmodel, params, tmodel = _models(cfg, tcfg)
    sampler = ts.get_sampler(tcfg)
    assert type(sampler) is ts.LBJF and sampler.num_corrector_steps == 0
    ref = _JaxSteps(cfg, jmodel, params)
    jstep = jax.jit(ref.lbjf)
    pts, phs = ts._time_grid(1.0, tcfg.sampler.min_t, tcfg.sampler.num_steps)
    rng = np.random.default_rng(4)
    x0 = _x_T(rng, cfg)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    dead = []  # share of rows with h * sum(rates) >= 1, i.e. diag = 0
    for k in range(K):
        g = _noise(rng, "g", x0.shape + (cfg.data.S,))
        jx = jstep(jx, pts[k], phs[k], jnp.asarray(g))
        with torch.no_grad():
            off = sampler._rev_rates(tmodel, tmodel.net, tx, float(pts[k])).sum(-1)
            dead.append(float((float(phs[k]) * off >= 1).float().mean()))
            tx = sampler.step(tmodel, tmodel.net, tx, float(pts[k]), float(phs[k]),
                              g=torch.from_numpy(g))
        assert tx.dtype == torch.int32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert np.mean(tx.numpy() != x0) > 0.02  # the chain moved
    # the flagship's steps see both branches of diag; the maze's only diag > 0
    assert (0 < np.mean(dead) < 1) if config == "flagship" else max(dead) == 0, dead


@pytest.mark.parametrize("name,kind", [("LBJF", "g"), ("TauL", "u")])
def test_k_steps_with_live_corrector_match_jax(name, kind):
    """Two corrector steps after every predictor step at or below the entry
    time; the entry time is a grid point, which the float32 comparison puts
    on the corrector's side."""
    cfg, tcfg = _cfgs("flagship", name, model_kw=MILD, num_corrector_steps=2)
    pts, phs = ts._time_grid(1.0, tcfg.sampler.min_t, tcfg.sampler.num_steps)
    for c in (cfg, tcfg):
        c.sampler.corrector_entry_time = float(pts[2])
    jmodel, params, tmodel = _models(cfg, tcfg)
    sampler = ts.get_sampler(tcfg)
    assert sampler.num_corrector_steps == 2
    ref = _JaxSteps(cfg, jmodel, params)
    jpred = jax.jit(ref.lbjf if name == "LBJF" else ref.taul)
    jcorr = jax.jit(ref.lbjf_corrector if name == "LBJF" else ref.taul_corrector)
    rng = np.random.default_rng(6)
    x0 = _x_T(rng, cfg)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    shape = x0.shape + (cfg.data.S,)
    corrected = 0
    for k in range(K):
        live = pts[k] <= np.float32(tcfg.sampler.corrector_entry_time)
        for phase in range(3 if live else 1):
            noise = _noise(rng, kind, shape)
            jfn, tfn = (jpred, sampler.step) if phase == 0 else \
                (jcorr, sampler.corrector_step)
            jx = jfn(jx, pts[k], phs[k], jnp.asarray(noise))
            with torch.no_grad():
                tx = tfn(tmodel, tmodel.net, tx, float(pts[k]), float(phs[k]),
                         **{kind: torch.from_numpy(noise)})
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            corrected += phase > 0
    assert corrected == 2 * 3  # steps 2, 3 and 4 of the grid
    assert np.mean(tx.numpy() != x0) > 0.05


@pytest.mark.parametrize("fused", [True, False])
def test_k_midpoint_steps_match_jax(fused):
    cfg, tcfg = _cfgs("flagship", "MidPointTauL", use_fused_update=fused)
    jmodel, params, tmodel = _models(cfg, tcfg)
    sampler = ts.get_sampler(tcfg)
    assert sampler._fused_applicable() == fused
    ref = _JaxSteps(cfg, jmodel, params)
    jstep = jax.jit(lambda x, t, u, h: ref.midpoint(x, t, h, u, fused),
                    static_argnums=3)
    pts, hs = sampler.time_grid()
    h = float(hs[0])
    assert hs.dtype == np.float64 and np.all(hs == h)
    # the JAX sampler's grid (samplers.py MidPointTauL._sample_loop)
    jh = (1.0 - cfg.sampler.min_t) / cfg.sampler.num_steps
    n = int(np.ceil((1.0 - 0.5 * jh - cfg.sampler.min_t) / jh - 1e-9))
    assert h == jh and len(pts) == n == cfg.sampler.num_steps
    np.testing.assert_array_equal(pts, (1.0 - jh * np.arange(n)).astype(np.float32))
    rng = np.random.default_rng(8)
    x0 = _x_T(rng, cfg)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    for k in range(K):
        u = _noise(rng, "u", x0.shape + (cfg.data.S,))
        jx = jstep(jx, pts[k], jnp.asarray(u), h)
        with torch.no_grad():
            tx = sampler.step(tmodel, tmodel.net, tx, float(pts[k]), h,
                              u=torch.from_numpy(u))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert np.mean(tx.numpy() != x0) > 0.05


@pytest.mark.parametrize("name,sampler_kw,change_tol", [
    ("LBJF", {}, 0.01),
    ("LBJF", {"num_corrector_steps": 1, "corrector_entry_time": 0.2}, 0.02),
    ("MidPointTauL", {"use_fused_update": True}, 0.01),
])
def test_whole_sampler_statistics_match_jax(name, sampler_kw, change_tol):
    """Change counts: dims changed per sample summed over the steps (LBJF:
    about 1800 of 3200 over 256 chains, sampling noise ~0.1%; MidPointTauL
    counts per dim, about 19 of 50). With the corrector the chains are
    perturbed between the counted predictor steps, so the allowance
    doubles."""
    cfg, tcfg = _cfgs("flagship", name, model_kw=MILD, **sampler_kw)
    jmodel, params, tmodel = _models(cfg, tcfg)
    N, S = 256, cfg.data.S
    jsamples, jchanges = js.get_sampler(cfg).sample(
        jmodel, params, jax.random.PRNGKey(0), N=N)
    tsamples, changes = ts.get_sampler(tcfg).sample(
        tmodel, tmodel.net, torch.Generator().manual_seed(0), N)
    assert tsamples.shape == jsamples.shape == (N, cfg.model.concat_dim)
    assert changes.shape == np.asarray(jchanges).shape
    hj = np.bincount(np.asarray(jsamples).ravel(), minlength=S) / jsamples.size
    ht = np.bincount(tsamples.ravel(), minlength=S) / tsamples.size
    tv = 0.5 * np.abs(hj - ht).sum()
    assert tv < 0.05, (tv, hj, ht)
    assert hj.max() < 0.9  # not collapsed onto one state
    jc, tc = float(np.sum(jchanges)), float(np.sum(changes))
    assert abs(tc - jc) / jc < change_tol, (tc, jc)
    # neither frozen nor moving every dim at every step
    per_step = np.asarray(changes) / (1 if name == "MidPointTauL" else cfg.model.concat_dim)
    assert 0.05 < per_step.mean() < 0.95, per_step


@pytest.mark.parametrize("name", ["tauUnet_mnist_ll", "tauUnet_maze",
                                  "mlp_synthetic"])
def test_preset_copy_matches_jax_preset(name):
    """Same keys and values as the JAX preset (tauUnet_mnist_ll inherits the
    flagship copy's explicit use_fused_update=False)."""
    want = jax_get_preset(name).to_dict()
    got = get_preset(name).to_dict()
    if name == "tauUnet_mnist_ll":
        assert got["sampler"].pop("use_fused_update") is False
    assert got == want


def test_lbjf_aliases_and_gumbel_noise():
    for alias in ("CRMLBJF", "LBJFSampling", "CRMebmLBJF"):
        assert registry.samplers.get(alias) is ts.LBJF
    g = ts.gumbel_noise(torch.Generator().manual_seed(0), (200000,), "cpu")
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler's constant, variance = pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03


def test_lbjf_hands_the_draw_a_distinct_key_at_every_call(monkeypatch):
    """One batch of LBJF with two corrector steps below the entry time: the
    draw (a stand-in around `rate_kernels.euler_posterior_draw`) gets the
    batch's base word and the step index as its seed, substep 0 for the
    predictor and k + 1 for the k-th corrector step: a distinct (seed,
    substep) at every call. ConditionalLBJF keys its steps the same way, and
    `lbjf_corrector_step` passes its `seed` on."""
    from ctdd_tpu_torch.ops import rate_kernels

    calls = []
    real = rate_kernels.euler_posterior_draw

    def stand_in(rev, x, h, *, seed=0, substep=0, g=None):
        calls.append((seed, substep))
        return real(rev, x, h, seed=seed, substep=substep, g=g)

    monkeypatch.setattr(rate_kernels, "euler_posterior_draw", stand_in)
    steps = 6
    cfg, tcfg = _cfgs("flagship", "LBJF", num_steps=steps, model_kw=MILD,
                      num_corrector_steps=2)
    pts, _ = ts._time_grid(1.0, tcfg.sampler.min_t, steps)
    tcfg.sampler.corrector_entry_time = float(pts[3])
    _, _, tmodel = _models(cfg, tcfg)
    sampler = ts.get_sampler(tcfg)
    samples, _ = sampler.sample(tmodel, tmodel.net, torch.Generator().manual_seed(0), 2)
    assert samples.shape == (2, cfg.model.concat_dim)
    live = int((pts <= np.float32(pts[3])).sum())
    assert live == 3 and len(calls) == steps + 2 * live
    assert len(set(calls)) == len(calls)  # every draw its own key
    base = calls[0][0] & 0xFFFFFFFF
    want = []
    for i in range(steps):
        want.append((base | (i << 32), 0))
        if i >= steps - live:
            want += [(base | (i << 32), 1), (base | (i << 32), 2)]
    assert calls == want

    # the conditional loop: one base per batch, step i keyed by (base, i)
    from test_torch_conditional import N as CN, P, pair

    _, ccfg, _, _, cmodel = pair()
    ccfg.sampler.name = "ConditionalLBJF"
    calls.clear()
    cond = np.zeros((CN, P), np.int64)
    ts.get_sampler(ccfg).sample(cmodel, cmodel.net, torch.Generator().manual_seed(1), CN,
                                conditioner=cond)
    cbase = calls[0][0] & 0xFFFFFFFF
    assert calls == [(cbase | (i << 32), 0) for i in range(ccfg.sampler.num_steps)]

    calls.clear()
    xt = torch.zeros((2, cfg.model.concat_dim), dtype=torch.int32)
    ts.lbjf_corrector_step(tcfg, tmodel, tmodel.net, torch.Generator(), xt, 0.4, 0.05, 2,
                           seed=123 | (7 << 32))
    assert calls == [(123 | (7 << 32), 0)]


def test_lbjf_draw_without_a_seed_keys_it_from_the_generator(monkeypatch):
    """Off the CPU (here `meta` tensors and a stand-in for the draw) a draw
    given no seed takes its key from `generator`: two calls, two keys, the
    same again after reseeding; a given seed is passed on and leaves the
    generator alone. LBJF's step and corrector step, ConditionalLBJF's step
    and `lbjf_corrector_step` take no seed by default."""
    import inspect

    from ctdd_tpu_torch.ops import rate_kernels

    calls = []

    def stand_in(rev, x, h, *, seed=0, substep=0, g=None):
        calls.append((seed, substep, g))
        return x

    monkeypatch.setattr(rate_kernels, "euler_posterior_draw", stand_in)
    rev = torch.empty((2, 3, 4), device="meta")
    x = torch.empty((2, 3), dtype=torch.int32, device="meta")
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        ts._categorical_euler_update(gen, x, rev, 0.1)
    gen.manual_seed(0)
    ts._categorical_euler_update(gen, x, rev, 0.1)
    (a, sa, ga), (b, sb, gb), (c, _, _) = calls
    assert ga is None and gb is None and sa == sb == 0
    assert a != b and a == c
    state = gen.get_state()
    ts._categorical_euler_update(gen, x, rev, 0.1, seed=7 | (1 << 32), substep=2)
    assert calls[-1][:2] == (7 | (1 << 32), 2)
    assert torch.equal(gen.get_state(), state)
    for fn in (ts.LBJF.step, ts.LBJF.corrector_step, ts.ConditionalLBJF.step,
               ts.lbjf_corrector_step):
        assert inspect.signature(fn).parameters["seed"].default is None
