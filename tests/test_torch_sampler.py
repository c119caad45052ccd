"""Port vs JAX: the TauL sampler on the tiny flagship config.

- K steps with the same x_T and the same per-step uniforms, fused and
  unfused, then the argmax denoise: states equal (the fused branch is held
  to the JAX fused mirror, the unfused one to the JAX composite).
- Whole-sampler statistics: total-variation distance of the final-state
  histograms below 0.05 (16384 states each; the sampling noise of that TV
  is about 0.01), and the summed per-step change counts within 1%.
- Oracle convergence: a net that always predicts class 0 drives both
  branches to state 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ctdd_tpu.ops import fused_update as jfu
from ctdd_tpu.ops import indexing as jidx
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import DiffusionModel, create_model
from ctdd_tpu_torch.ops.forward_process import make_uniform
from ctdd_tpu_torch.sampling import samplers as ts
from tests.test_torch_unet import (  # noqa: F401
    flagship_cfgs, one_torch_thread, port_net, seeded_flax_params,
)

K = 5


def _setup(fused: bool, num_steps: int = 50):
    cfg, tcfg = flagship_cfgs("tiny")
    for c in (cfg, tcfg):
        c.sampler.num_steps = num_steps
        c.sampler.use_fused_update = fused
    jmodel, params = seeded_flax_params(cfg, seed=3, scale=0.15)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(port_net(tcfg, params).state_dict())
    tmodel.net.eval()
    return cfg, tcfg, jmodel, params, tmodel


def _jax_step(cfg, jmodel, params, x, t, h, u, fused):
    S = cfg.data.S
    eps = cfg.sampler.eps_ratio
    t_ones = t * jnp.ones((x.shape[0],), jnp.float32)
    logits = jmodel.apply(params, x, t_ones)
    qt0, rate = js._shared_mats(jmodel.process, t)
    if fused:
        return jfu.fused_tau_leap_update_xla(
            logits, x, x, qt0, rate, h, eps, u=u, mode="poisson",
        )
    rev = js.reverse_rates_shared(jmodel.process, logits, x, t,
                                  rate_param="p0t", logit_type="direct", eps=eps)
    rev = rev * jidx.onehot_mask(x, S)
    n = jfu._poisson_inversion_from_u(u, rev * h)
    diff = (jnp.arange(S)[None, None, :] - x[:, :, None]).astype(jnp.float32)
    return jnp.clip(x + jnp.sum(n * diff, axis=-1).astype(jnp.int32), 0, S - 1)


@pytest.mark.parametrize("fused", [True, False])
def test_k_taul_steps_match_jax(fused):
    cfg, tcfg, jmodel, params, tmodel = _setup(fused)
    sampler = ts.get_sampler(tcfg)
    assert sampler._fused_applicable() == fused
    N, D, S = 4, cfg.model.concat_dim, cfg.data.S
    jts, jhs = js._time_grid(1.0, cfg.sampler.min_t, cfg.sampler.num_steps)
    pts, phs = ts._time_grid(1.0, tcfg.sampler.min_t, tcfg.sampler.num_steps)
    np.testing.assert_array_equal(pts, np.asarray(jts))
    np.testing.assert_array_equal(phs, np.asarray(jhs))

    rng = np.random.default_rng(4)
    x0 = rng.integers(0, S, (N, D)).astype(np.int32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstep = jax.jit(lambda x, t, h, u: _jax_step(cfg, jmodel, params, x, t, h, u, fused))
    for k in range(K):
        u = rng.random((N, D, S)).astype(np.float32)
        jx = jstep(jx, jts[k], jhs[k], jnp.asarray(u))
        with torch.no_grad():
            tx = sampler.step(tmodel, tmodel.net, tx, float(pts[k]), float(phs[k]),
                              u=torch.from_numpy(u))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert np.mean(tx.numpy() != x0) > 0.05  # the chain moved

    want = js._denoise_argmax(jmodel, params, jx, cfg.sampler.min_t, N)
    with torch.no_grad():
        got = ts._denoise_argmax(tmodel, tmodel.net, tx, tcfg.sampler.min_t, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fused", [True, False])
def test_whole_sampler_statistics_match_jax(fused):
    cfg, tcfg, jmodel, params, tmodel = _setup(fused)
    N, S = 256, cfg.data.S
    jsamples, jchanges = js.get_sampler(cfg).sample(
        jmodel, params, jax.random.PRNGKey(0), N=N
    )
    tsamples, changes = ts.get_sampler(tcfg).sample(
        tmodel, tmodel.net, torch.Generator().manual_seed(0), N
    )
    assert tsamples.shape == jsamples.shape == (N, cfg.model.concat_dim)
    assert changes.shape == (cfg.sampler.num_steps,)
    hj = np.bincount(np.asarray(jsamples).ravel(), minlength=S) / jsamples.size
    ht = np.bincount(tsamples.ravel(), minlength=S) / tsamples.size
    tv = 0.5 * np.abs(hj - ht).sum()
    assert tv < 0.05, (tv, hj, ht)
    assert hj.max() < 0.9  # not collapsed onto one state: the TV says something
    # the chains' dynamics: dims changed per sample, summed over the steps
    # (~3100 here; its sampling noise over 256 chains is ~0.02%)
    jc, tc = float(np.sum(jchanges)), float(np.sum(changes))
    assert abs(tc - jc) / jc < 0.01, (tc, jc)


class OracleNet(nn.Module):
    """Always predicts class 0 with high (finite) confidence."""

    def __init__(self, S: int, confidence: float = 5.0):
        super().__init__()
        self.S = S
        self.confidence = confidence

    def forward(self, x, t):
        logits = torch.zeros(x.shape[0], x.shape[1], self.S)
        logits[:, :, 0] = self.confidence
        return logits


@pytest.mark.parametrize("fused,exact_poisson", [(True, False), (False, False),
                                                 (False, True)])
@pytest.mark.parametrize("loss_name", ["CTElbo", "NLLOriginal"])
def test_oracle_converges_to_class_zero(fused, exact_poisson, loss_name):
    S, D = 4, 6
    cfg = get_preset("tauUnet_mnist")
    cfg.data.S = S
    cfg.data.shape = [D]
    cfg.model.concat_dim = D
    cfg.loss.name = loss_name
    cfg.sampler.num_steps = 100
    cfg.sampler.initial_dist = "uniform"
    cfg.sampler.use_fused_update = fused
    cfg.sampler.exact_poisson = exact_poisson  # torch.poisson draws
    model = DiffusionModel(net=OracleNet(S), process=make_uniform(S, 1.5, device="cpu"), cfg=cfg)
    samples, _ = ts.get_sampler(cfg).sample(
        model, model.net, torch.Generator().manual_seed(0), 32
    )
    assert np.mean(samples == 0) > 0.9


def test_later_slices_raise_not_implemented():
    """A live corrector constructs and runs (its steps follow every
    predictor step at or below the entry time); a label is refused by a
    model that is not label-conditional."""
    _, tcfg = flagship_cfgs("tiny")
    tcfg.sampler.num_steps = 10
    tcfg.sampler.num_corrector_steps = 3
    tcfg.sampler.corrector_entry_time = 0.5  # a live corrector
    sampler = ts.get_sampler(tcfg)
    assert sampler.num_corrector_steps == 3
    model = create_model(tcfg, device="cpu")
    calls = []
    inner = sampler.corrector_step
    sampler.corrector_step = lambda *a, **kw: (calls.append(a[3]), inner(*a, **kw))[1]
    samples, changes = sampler.sample(model, model.net,
                                      torch.Generator().manual_seed(0), 2)
    grid, _ = ts._time_grid(1.0, tcfg.sampler.min_t, 10)
    live = [float(t) for t in grid if t <= np.float32(0.5)]
    assert 0 < len(live) < 10 and calls == [t for t in live for _ in range(3)]
    assert samples.shape == (2, 64) and changes.shape == (10,)
    assert samples.min() >= 0 and samples.max() < tcfg.data.S
    with pytest.raises(ValueError, match="not label-conditional"):
        sampler.sample(model, model.net, torch.Generator(), 2, label=[0, 1])
