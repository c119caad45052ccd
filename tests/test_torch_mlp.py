"""Port vs JAX: the residual MLP, its zoo entries, its initializers, one
`mlp_synthetic` train step, and `mlp_synthetic` trained and served on the
CPU end to end.

Every flax leaf is filled with seeded normals and carried across by
`mlp_params_from_flax`. Float32 on both sides; the time embedding's
arguments reach ~1e3, where the f32 argument itself carries ~1e-4 of
rounding, and the logits reach ~30: rtol 1e-4, atol 1e-3. The train step:
the loss to rtol 1e-5, each gradient leaf to 1e-4 of its largest |g|,
params and EMA after the step to 1e-2 of the learning rate, as
tests/test_torch_train_step.py holds the UNet's.
"""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu.training.optimizers import get_optimizer as jax_optimizer
from ctdd_tpu.training.state import create_train_state as jax_train_state
from ctdd_tpu.training.train_step import apply_update as jax_apply_update
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.convert import mlp_params_from_flax
from ctdd_tpu_torch.data.loaders import get_dataset
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.losses.losses import get_loss
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks.mlp import ResidualMLP
from ctdd_tpu_torch.serving import SamplerService, run_http_server
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.training.train_step import apply_update, value_and_grad
from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint
from tests.test_torch_losses import injected
from tests.test_torch_unet import one_torch_thread  # noqa: F401


def _seeded_flax(cfg, seed=0, scale=0.2):
    model = jax_create_model(cfg)
    D = cfg.model.concat_dim
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32), jnp.full((2,), 0.5)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
    return model, params


@pytest.mark.parametrize("model_name,S", [("UniformRateResMLP", 2),
                                          ("GaussianRateResidualMLP", 8)])
def test_mlp_logits_match_jax(model_name, S):
    cfg = jax_get_preset("mlp_synthetic")
    tcfg = get_preset("mlp_synthetic")
    for c in (cfg, tcfg):
        c.model.name = model_name
        c.data.S = S
        c.model.num_layers = 2
        # the Gaussian process's settings, as the flagship has them
        c.model.rate_sigma, c.model.time_base, c.model.time_exp = 6.0, 3.0, 100.0
    model, params = _seeded_flax(cfg, seed=1)
    tmodel = create_model(tcfg, device="cpu")
    assert isinstance(tmodel.net, ResidualMLP)
    assert tcfg.model.rate_name == cfg.model.rate_name
    tmodel.net.load_state_dict(mlp_params_from_flax(params, tmodel.net))
    rng = np.random.default_rng(2)
    x = rng.integers(0, S, (3, 32)).astype(np.int32)
    t = np.array([0.007, 0.5, 0.99], np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(t))
    assert got.is_contiguous() and got.shape == (3, 32, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert np.abs(want).max() > 1.0


def test_mlp_convert_rejects_missing_extra_and_misshapen_leaves():
    cfg = jax_get_preset("mlp_synthetic")
    _, params = _seeded_flax(cfg)
    params = dict(jax.tree_util.tree_map(np.asarray, params))
    net = create_model(get_preset("mlp_synthetic"), device="cpu").net
    head = params.pop("Dense_10")
    with pytest.raises(KeyError, match="no flax leaf"):
        mlp_params_from_flax(params, net)
    params["Dense_10"] = head
    params["Dense_11"] = head
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        mlp_params_from_flax(params, net)
    params.pop("Dense_11")
    params["LayerNorm_3"] = params["LayerNorm_0"]
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        mlp_params_from_flax(params, net)
    params.pop("LayerNorm_3")
    params["Dense_10"] = {"kernel": head["kernel"][:, :1], "bias": head["bias"]}
    with pytest.raises(ValueError, match="shape"):
        mlp_params_from_flax(params, net)


def test_mlp_synthetic_served_on_the_cpu(tmp_path):
    """Checkpoint -> SamplerService -> /generate with the shipped LBJF/100
    sampler; the flax weights come across through the converter."""
    jcfg = jax_get_preset("mlp_synthetic")
    cfg = get_preset("mlp_synthetic")
    _, params = _seeded_flax(jcfg, seed=3, scale=0.1)
    model = create_model(cfg, device="cpu")
    sd = mlp_params_from_flax(params, model.net)
    path = save_checkpoint(str(tmp_path / "mlp.pt"), sd, sd, step=11, config=cfg)
    svc = SamplerService(cfg, path, batch=8, device="cpu")
    assert type(svc.sampler).__name__ == "LBJF" and svc.sampler.num_steps == 100
    server = run_http_server(svc, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n=12",
                                    timeout=120) as r:
            payload = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    samples = np.asarray(payload["samples"])
    assert payload["shape"] == [12, 32] and samples.shape == (12, 32)
    assert set(np.unique(samples)) <= {0, 1}
    assert 0.05 < samples.mean() < 0.95  # both states appear


def test_init_weights_are_flax_defaults():
    """lecun_normal kernels (truncated at 2 std, fan_in), zero biases,
    LayerNorm ones and zeros; per layer the spread of JAX's own init; the
    draws follow the generator."""
    cfg = jax_get_preset("mlp_synthetic")
    model = jax_create_model(cfg)
    D = cfg.model.concat_dim
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32), jnp.full((2,), 0.5))
    want = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                create_model(get_preset("mlp_synthetic"), device="cpu").net)
    net = create_model(get_preset("mlp_synthetic"), device="cpu").net
    net.init_weights(torch.Generator().manual_seed(0))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, w in got.items():
        if k.startswith("norms.") and k.endswith("weight"):
            assert torch.equal(w, torch.ones_like(w)), k
        elif k.endswith("bias"):
            assert torch.equal(w, torch.zeros_like(w)) and torch.equal(want[k], w), k
        else:
            fan_in = w.shape[1]
            std = np.sqrt(1.0 / fan_in)
            assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6, k
            assert abs(w.std().item() - std) <= 0.1 * std, (k, w.std().item(), std)
            assert abs(w.std().item() - want[k].std().item()) <= 0.1 * std, k
    again = create_model(get_preset("mlp_synthetic"), device="cpu").net
    again.init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in got.items())
    again.init_weights(torch.Generator().manual_seed(1))
    assert not torch.equal(again.dense_in.weight, got["dense_in.weight"])


def test_mlp_synthetic_train_step_matches_jax():
    """One CTElbo step of `mlp_synthetic` (clip, Adam, EMA) from the same
    flax weights, with the same injected times and (x_t, x̃)."""
    cfg, tcfg = jax_get_preset("mlp_synthetic"), get_preset("mlp_synthetic")
    jmodel, params = _seeded_flax(cfg, seed=5, scale=0.1)
    tmodel = create_model(tcfg, device="cpu")
    sd = mlp_params_from_flax(params, tmodel.net)
    tmodel.net.load_state_dict(sd)
    eps, decay, lr = cfg.loss.eps_ratio, float(cfg.model.ema_decay), float(cfg.optimizer.lr)
    x0, ts, xt, xtl = injected(tmodel, seed=2, ts=(0.02, 0.3, 0.7, 0.95))
    jtx, tx = jax_optimizer(cfg), get_optimizer(tcfg)

    def jloss(p):
        return JL._ctelbo_terms(jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0),
                                jnp.asarray(ts), eps, True, False, None,
                                samples=(jnp.asarray(xt), jnp.asarray(xtl)))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jstate, _ = jax.jit(lambda s, l, g: jax_apply_update(s, l, g, jtx, decay))(
        jax_train_state(params, jtx), jl, jg)

    state = create_train_state({k: v.clone() for k, v in sd.items()}, tx)
    value, grads = value_and_grad(lambda p: TL._ctelbo_terms(
        tmodel, p, None, torch.from_numpy(x0), torch.from_numpy(ts), eps, True, False,
        samples=(torch.from_numpy(xt), torch.from_numpy(xtl)))[0], state.params)
    state, tl = apply_update(state, value, grads, tx, decay)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    want_g = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, jg), tmodel.net)
    for k, g in grads.items():
        scale = want_g[k].abs().max().item()
        assert (g - want_g[k]).abs().max().item() <= 1e-4 * max(scale, 1e-30), k
    for mine, theirs in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        want = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, theirs), tmodel.net)
        for k, v in mine.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-2 * lr, err_msg=k)
    assert (state.step, state.opt_state.count, state.ema_num_updates) == (1, 1, 1)


def test_train_mlp_synthetic_on_the_cpu(tmp_path):
    """train() from the JAX package's initializers on generated 2spirals
    bits: 20 steps, the loss on a fixed batch with fixed draws falls."""
    cfg = get_preset("mlp_synthetic")
    cfg.save_location = str(tmp_path / "runs")
    cfg.data.location = str(tmp_path / "none.npy")
    cfg.data.num_samples = 2000
    cfg.optimizer.lr = 2e-3  # 20 steps at the preset's 1.5e-4 move the loss by its noise

    batch = torch.from_numpy(get_dataset(cfg).data[:256])

    @torch.no_grad()
    def fixed_loss(model, params):
        return float(get_loss(cfg).calc_loss(model, params, torch.Generator().manual_seed(1),
                                             batch, train=False))

    start = create_model(cfg, device="cpu")
    start.net.init_weights(torch.Generator().manual_seed(0))
    state, info = train(cfg, n_iters=20, seed=0, device="cpu", log_every=10)
    assert state.step == 20 and len(info["step_losses"]) == 20
    assert np.isfinite(info["step_losses"]).all() and max(info["step_losses"]) < 1e9
    before = fixed_loss(start, dict(start.net.named_parameters()))
    after = fixed_loss(info["model"], state.params)
    assert after < before, (before, after)
    assert sorted(os.listdir(info["paths"]["checkpoints"])) == ["20.pt"]
