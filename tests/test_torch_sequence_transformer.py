"""Port vs JAX: the sequence transformer (`networks/transformer.py`) of the
prefix-conditional path, its zoo entries and its weight conversion
(`convert.sequence_transformer_params_from_flax`).

Tiny widths (d_model 8, 2 heads, feed-forward 12, 2 layers, 2 output
residual blocks, L=10, S=7); every flax leaf redrawn from seeded normals
(std 0.5). Eval mode (dropout off), float32 on both sides. Tolerance: 1e-5
of the largest |logit| (and of the largest key logit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import sequence_transformer_params_from_flax
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks.transformer import SequenceTransformer
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

L, S = 10, 7
REL_TOL = 1e-5


def seq_cfgs(**model):
    """(JAX cfg, port cfg) of `pianoroll_cond` at the tiny width."""
    cfg = jax_get_preset("pianoroll_cond")
    with cfg.unlocked():
        m = cfg.model
        m.num_layers, m.d_model, m.num_heads = 2, 8, 2
        m.dim_feedforward, m.temb_dim = 12, 4
        cfg.data.S, cfg.data.shape, m.concat_dim = S, [L], L
        cfg.loss.condition_dim = cfg.sampler.condition_dim = 3
        for k, v in model.items():
            m[k] = v
    return cfg, Config(cfg.to_dict())


def seeded(cfg, seed=1, scale=0.5):
    model = jax_create_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, L), jnp.int32), jnp.full((2,), 0.5)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    return model, params


def port(tcfg, params):
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(sequence_transformer_params_from_flax(params, model.net))
    model.net.eval()
    return model


def inputs(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, S, (3, L)).astype(np.int32),
            np.array([0.01, 0.5, 0.95], np.float32))


def close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


CASES = {
    "preset": {},  # qk_norm, scale_input_embedding, one-hot input
    "reference_net": dict(qk_norm=False, scale_input_embedding=False),
    "qk_norm_only": dict(scale_input_embedding=False),
    "embed_input": dict(use_one_hot_input=False),
    "scalar_input": dict(use_cat=False),
    "aux_head": dict(aux_key_classes=12),
    "no_residual_blocks": dict(num_output_FFresiduals=0, num_layers=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    cfg, tcfg = seq_cfgs(**CASES[case])
    jmodel, params = seeded(cfg)
    model = port(tcfg, params)
    assert isinstance(model.net, SequenceTransformer)
    x, t = inputs()
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.apply(model.net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert want.shape == (3, L, S)
    close(got, want)


def test_aux_key_head_matches_jax():
    """`return_aux` gives (logits, key logits) on both sides; without it the
    port returns the logits alone, as JAX does."""
    cfg, tcfg = seq_cfgs(aux_key_classes=12)
    jmodel, params = seeded(cfg, seed=3)
    model = port(tcfg, params)
    x, t = inputs(4)
    wl, wk = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, return_aux=True))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        gl, gk = model.apply(model.net, torch.from_numpy(x), torch.from_numpy(t),
                             return_aux=True)
        plain = model.apply(model.net, torch.from_numpy(x), torch.from_numpy(t))
    assert gk.shape == (3, L, 12)
    close(gl.numpy(), np.asarray(wl))
    close(gk.numpy(), np.asarray(wk))
    assert torch.equal(plain, gl)


@pytest.mark.parametrize("model_kw", [{}, dict(use_one_hot_input=False),
                                      dict(aux_key_classes=12)])
def test_conversion_covers_every_leaf(model_kw):
    """Every flax leaf lands on one port parameter of its shape (the Dense
    numbering moves when the input is embedded), and a leaf left over or
    missing raises."""
    cfg, tcfg = seq_cfgs(**model_kw)
    _, params = seeded(cfg)
    net = create_model(tcfg, device="cpu").net
    sd = sequence_transformer_params_from_flax(params, net)
    n_flax = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_flax == len(dict(net.named_parameters()))
    assert ("Embed_0.weight" in sd) == ("use_one_hot_input" in model_kw)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["EncoderLayer_0"]["Dense_9"] = {"kernel": np.zeros((8, 8), np.float32)}
    with pytest.raises(KeyError):
        sequence_transformer_params_from_flax(extra, net)
    fewer = {k: v for k, v in params.items() if k != "FFResidual_0"}
    with pytest.raises(KeyError):
        sequence_transformer_params_from_flax(fewer, net)


def test_both_zoo_entries_build_the_network():
    """UniformRate and BirthDeath sequence-transformer entries: the port's
    process tables equal JAX's."""
    for name, extra in (("UniformRateSequenceTransformerEMA", {}),
                        ("BirthDeathRateSequenceTransformerEMA",
                         dict(sigma_min=1.0, sigma_max=3.0))):
        cfg, tcfg = seq_cfgs(name=name, **extra)
        jmodel = jax_create_model(cfg)
        model = create_model(tcfg, device="cpu")
        assert isinstance(model.net, SequenceTransformer)
        t = np.array([0.1, 0.6], np.float32)
        np.testing.assert_allclose(model.transition(torch.from_numpy(t)).numpy(),
                                   np.asarray(jmodel.transition(jnp.asarray(t))),
                                   rtol=1e-5, atol=1e-6)


def test_dropout_trains_and_is_seeded():
    """In training mode the attention and block dropouts are on and draw from
    the default generator: two passes from one seed agree, another seed
    differs, and eval mode has no randomness."""
    _, tcfg = seq_cfgs()
    model = create_model(tcfg, device="cpu")
    model.net.init_weights(torch.Generator().manual_seed(0))
    x, t = (torch.from_numpy(a) for a in inputs())
    outs = []
    for seed in (5, 5, 6):
        torch.manual_seed(seed)
        outs.append(model.apply(model.net, x, t, train=True).detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        assert torch.equal(model.apply(model.net, x, t), model.apply(model.net, x, t))
