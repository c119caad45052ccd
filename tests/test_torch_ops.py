"""Port vs JAX: the small tensor ops, config, registry and model plumbing.

Gathers and masks are exact; the embeddings are float32 sin/cos/exp of
arguments in [0, 1] (rtol 1e-6, atol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.ops import indexing as jidx
from ctdd_tpu.ops import timestep as jts
from ctdd_tpu_torch import registry
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.ops import indexing as tidx
from ctdd_tpu_torch.ops import timestep as tts
from ctdd_tpu_torch.sampling import samplers  # noqa: F401  (registers TauL)
from tests.test_torch_unet import flagship_cfgs, one_torch_thread  # noqa: F401


def _mat_idx(B=3, D=5, S=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, S)).astype(np.float32),
            rng.integers(0, S, (B, D)).astype(np.int32))


@pytest.mark.parametrize("fn", ["rows", "cols", "zero_at", "onehot_mask"])
def test_indexing_matches_jax(fn):
    mat, idx = _mat_idx()
    S = mat.shape[-1]
    x = np.random.default_rng(1).standard_normal((3, 5, S)).astype(np.float32)
    args = {"rows": (mat, idx), "cols": (mat, idx), "zero_at": (x, idx),
            "onehot_mask": (idx, S)}[fn]
    want = getattr(jidx, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args])
    got = getattr(tidx, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim", [8, 96, 33])
def test_timestep_embedding_matches_jax(dim):
    # the samplers' time range; at arguments ~1e3 the f32 argument itself
    # carries ~1e-4 of rounding and the two sin/cos would differ by that
    t = np.array([0.0, 0.01, 0.37, 1.0], np.float32)
    want = np.asarray(jts.timestep_embedding(jnp.asarray(t), dim))
    got = tts.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == (4, dim)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_center_data_matches_jax():
    x = np.arange(0, 256, 5, dtype=np.int32)
    want = np.asarray(jts.center_data(jnp.asarray(x), (0, 255)))
    got = tts.center_data(torch.from_numpy(x), (0, 255)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_preset_copy_matches_jax_preset():
    """Same keys and values as the JAX preset (the port adds the sampler's
    use_fused_update key the JAX preset leaves to its default: off)."""
    want = jax_get_preset("tauUnet_mnist").to_dict()
    got = get_preset("tauUnet_mnist").to_dict()
    assert got["sampler"].pop("use_fused_update") is False
    assert got == want
    with pytest.raises(KeyError, match="known"):
        get_preset("nope")


def test_config_attribute_access_and_round_trip():
    cfg = Config({"a": {"b": 1}, "c": [1, 2]})
    assert cfg.a.b == 1 and cfg.get("missing", 3) == 3 and "c" in cfg
    cfg.a.d = {"e": 2.5}
    assert Config(cfg.to_dict()).to_dict() == {"a": {"b": 1, "d": {"e": 2.5}},
                                                "c": [1, 2]}
    with pytest.raises(AttributeError, match="known"):
        cfg.nope


def test_registry_names_and_errors():
    assert "GaussianTargetRateImageX0PredEMAPaul" in registry.models
    assert registry.samplers.get("ElboTauL") is registry.samplers.get("TauL")
    with pytest.raises(ValueError, match="already registered"):
        registry.samplers.register(registry.samplers.get("TauL"), name="TauL")
    with pytest.raises(KeyError, match="no sampler"):
        registry.samplers.get("nope")


def test_model_apply_takes_a_module_or_a_state_dict():
    _, tcfg = flagship_cfgs("tiny")
    torch.manual_seed(0)
    model = create_model(tcfg)
    model.net.eval()
    assert tcfg.model.rate_name == "GaussianTargetRate"
    x = torch.randint(0, 8, (2, 64), dtype=torch.int32)
    t = torch.tensor([0.2, 0.8])
    shifted = {k: v + 0.05 for k, v in model.net.state_dict().items()}
    with torch.no_grad():
        base = model.apply(model.net, x, t)
        other = model.apply(shifted, x, t)
        model.net.load_state_dict(shifted)
        loaded = model.apply(model.net, x, t)
    assert not torch.equal(base, other)
    torch.testing.assert_close(other, loaded, rtol=0, atol=0)
