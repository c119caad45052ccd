"""The hollow family's presets in the port on the CPU: the preset copies
against the JAX presets, every preset building a model and a sampler, and
the synthetic presets trained a few steps through `train()` at a tiny width,
then sampled through LBJF and served from the trainer's checkpoint."""

import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu_torch.config.presets import get_preset, preset_names
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.serving import SamplerService
from ctdd_tpu_torch.training.loop import train
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

NEW = ["hollow_synthetic", "hollow_synthetic_rmdirect", "bert_synthetic",
       "masked_synthetic", "hollow_mnist", "holvisual_mnist", "bert_mnist"]
EARLIER = ["tauUnet_mnist", "tauUnet_mnist_ll", "tauUnet_maze", "mlp_synthetic"]
NETWORKS = {"hollow_synthetic": "HollowTransformerWrapper",
            "hollow_synthetic_rmdirect": "HollowTransformerWrapper",
            "bert_synthetic": "BertEnumTransformerWrapper",
            "masked_synthetic": "EnumerativeTransformerWrapper",
            "hollow_mnist": "HollowTransformerWrapper",
            "holvisual_mnist": "HollowTransformerWrapper",
            "bert_mnist": "BertEnumTransformerWrapper"}


def test_the_port_has_eleven_presets():
    """The eleven presets of slices 1-6 stay (later slices add theirs)."""
    assert set(NEW + EARLIER) <= set(preset_names())


@pytest.mark.parametrize("name", NEW)
def test_preset_copy_matches_jax_preset(name):
    assert get_preset(name).to_dict() == jax_get_preset(name).to_dict()


@pytest.mark.parametrize("name", NEW + EARLIER)
def test_every_preset_builds_a_model_and_a_sampler(name):
    """At the preset's full width on the CPU; the CRM losses sample on the
    ratio path, the tauLDR ones on the p0t path."""
    cfg = get_preset(name)
    model = create_model(cfg, device="cpu")
    sampler = get_sampler(cfg)
    if name in NETWORKS:
        assert type(model.net).__name__ == NETWORKS[name]
    ratio = cfg.loss.name not in ("CTElbo", "NLLOriginal")
    assert sampler.rate_param == ("ratio" if ratio else "p0t")
    assert sum(p.numel() for p in model.net.parameters()) > 0


def tiny(name, tmp_path):
    cfg = get_preset(name)
    m = cfg.model
    m.embed_dim = m.qkv_dim = 16
    m.num_layers, m.mlp_dim, m.num_heads = 1, 32, 2
    cfg.data.num_samples, cfg.data.batch_size = 512, 16
    cfg.data.location = str(tmp_path / "absent.npy")  # generated from seed 0
    cfg.save_location = str(tmp_path / "runs")
    cfg.sampler.num_steps, cfg.sampler.sample_freq = 6, 0
    return cfg


@pytest.mark.parametrize("name", ["hollow_synthetic", "bert_synthetic", "masked_synthetic",
                                  "hollow_synthetic_rmdirect"])
def test_train_then_sample_and_serve(name, tmp_path):
    """Four steps through train() (a finite loss every step, the weights
    moved), LBJF samples of the EMA weights, and the trainer's checkpoint
    served by SamplerService."""
    cfg = tiny(name, tmp_path)
    state, info = train(cfg, n_iters=4, seed=1, device="cpu", log_every=2)
    losses = np.asarray(info["step_losses"])
    assert losses.shape == (4,) and np.isfinite(losses).all() and losses.max() < 1e9
    start = create_model(cfg, device="cpu").net
    start.init_weights(torch.Generator().manual_seed(1))
    assert any(not torch.equal(v, state.params[k]) for k, v in start.named_parameters())

    sampler = get_sampler(cfg)
    samples, changes = sampler.sample(info["model"], state.ema_params,
                                      torch.Generator().manual_seed(0), 5)
    assert samples.shape == (5, 32) and set(np.unique(samples)) <= {0, 1}
    assert changes.shape == (cfg.sampler.num_steps,)

    svc = SamplerService(cfg, f"{info['paths']['checkpoints']}/4.pt", batch=4, device="cpu")
    out = svc.generate(6)
    assert out.shape == (6, 32) and set(np.unique(out)) <= {0, 1}
