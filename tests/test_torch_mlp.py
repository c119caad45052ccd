"""Port vs JAX: the residual MLP, its zoo entries, and `mlp_synthetic` served
on the CPU end to end.

Every flax leaf is filled with seeded normals and carried across by
`mlp_params_from_flax`. Float32 on both sides; the time embedding's
arguments reach ~1e3, where the f32 argument itself carries ~1e-4 of
rounding, and the logits reach ~30: rtol 1e-4, atol 1e-3.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.convert import mlp_params_from_flax
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks.mlp import ResidualMLP
from ctdd_tpu_torch.serving import SamplerService, run_http_server
from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint
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
