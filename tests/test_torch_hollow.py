"""Port vs JAX: the hollow-transformer family's logits after carrying the
flax weights across (`convert.hollow_params_from_flax`).

Tiny widths (E=8, 2 heads, 2 layers, D=5, S=4); every leaf is redrawn from
seeded normals (std 0.5) so no zero-initialized layer hides another. Eval
mode (dropout off); float32 on both sides. Tolerance: 1e-5 of the largest
|logit| (read 2e-7 to 1.3e-6 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import hollow_params_from_flax
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks import hollow
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

REL_TOL = 1e-5
D, S = 5, 4


def tiny_cfgs(preset: str, **model):
    """(JAX cfg, port cfg) of `preset` at the tiny width, with `model`
    overrides."""
    cfg = jax_get_preset(preset)
    with cfg.unlocked():
        m = cfg.model
        m.embed_dim = m.qkv_dim = 8
        m.num_layers, m.mlp_dim, m.num_heads = 2, 12, 2
        cfg.data.S = m.out_dim = m.readout_dim = S
        cfg.data.shape, m.concat_dim = [D], D
        for k, v in model.items():
            m[k] = v
    return cfg, Config(cfg.to_dict())


def seeded_params(cfg, seed=1, scale=0.5):
    model = jax_create_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32), jnp.full((2,), 0.5)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    return model, params


def port_model(tcfg, params):
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(hollow_params_from_flax(params, model.net))
    model.net.eval()
    return model


def inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, S, (3, D)).astype(np.int32)
    return x, np.array([0.01, 0.5, 0.95], np.float32)


def assert_logits_match(cfg, tcfg, seed=1):
    jmodel, params = seeded_params(cfg, seed)
    model = port_model(tcfg, params)
    x, t = inputs()
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.apply(model.net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3, D, S)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err
    return got


CASES = {
    "attention_prenorm_raw_temb": ("hollow_synthetic", {}),
    "attention_postnorm": ("hollow_synthetic", dict(transformer_norm_type="postnorm")),
    "attention_learned_temb": ("hollow_synthetic", dict(nets="bidir_transformer")),
    "concat_readout": ("hollow_synthetic", dict(bidir_readout="concat")),
    "res_concat_learned_temb": ("hollow_synthetic", dict(bidir_readout="res_concat",
                                                         nets="bidir_transformer")),
    "res_concat_raw_temb_postnorm": ("hollow_synthetic", dict(
        bidir_readout="res_concat", transformer_norm_type="postnorm")),
    "categorical_embed": ("hollow_synthetic", dict(use_cat=True)),
    "one_hot_embed": ("hollow_synthetic", dict(use_cat=True, use_one_hot_input=True)),
    "uniform_hollow_mnist_family": ("hollow_mnist", {}),
    "logistics_fixed": ("hollow_synthetic", dict(name="UniVarHollowEMALogistics",
                                                 fix_logistic=True)),
    "bert_resnet": ("bert_synthetic", {}),
    "bert_mlp_readout": ("bert_synthetic", dict(readout="mlp")),
    "bert_categorical": ("bert_synthetic", dict(use_cat=True)),
    "masked_enumerative_resnet": ("masked_synthetic", {}),
    "masked_enumerative_mlp": ("masked_synthetic", dict(readout="mlp")),
    "masked_enumerative_categorical": ("masked_synthetic", dict(use_cat=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    preset, model = CASES[case]
    assert_logits_match(*tiny_cfgs(preset, **model))


def test_logistics_head_inputs_match_jax():
    """Without the min-trick the truncated-logistic logits are ill-conditioned
    in the far bins (log(1 - e^d + 1e-6) amplifies a 1e-7 change of d up to
    1e6-fold), so the unfixed head is held at its inputs: the transformer's
    (mu, log_scale), within 1e-5 of their largest |value|; the head itself is
    held on identical inputs in test_torch_logprob.py."""
    cfg, tcfg = tiny_cfgs("hollow_synthetic", name="UniVarHollowEMALogistics",
                          fix_logistic=False)
    jmodel, params = seeded_params(cfg)
    model = port_model(tcfg, params)
    x, t = inputs()
    from ctdd_tpu.networks.hollow import BidirectionalTransformer

    inner = BidirectionalTransformer(jmodel.module.cfg, readout_dim=2, learned_temb=False)
    want = np.asarray(inner.apply({"params": params["BidirectionalTransformer_0"]},
                                  jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.net.BidirectionalTransformer_0(torch.from_numpy(x),
                                                   torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3, D, 2)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_enumerative_logit_at_a_position_ignores_that_position():
    """Each position's logits come from the input with that position
    masked: changing x at position d leaves the logits at d unchanged."""
    _, tcfg = tiny_cfgs("masked_synthetic")
    model = create_model(tcfg, device="cpu")
    model.net.init_weights(torch.Generator().manual_seed(0))
    model.net.eval()
    x, t = (torch.from_numpy(a) for a in inputs())
    y = x.clone()
    y[:, 2] = (y[:, 2] + 1) % S
    with torch.no_grad():
        a, b = model.apply(model.net, x, t), model.apply(model.net, y, t)
    assert torch.equal(a[:, 2], b[:, 2])
    assert not torch.equal(a[:, 3], b[:, 3])


@pytest.mark.parametrize("preset", ["hollow_synthetic", "bert_synthetic"])
def test_hollow_logits_at_a_position_ignore_that_position(preset):
    """The hollow towers never see x_d when reading out d; the Bert encoder
    does (it is not hollow)."""
    _, tcfg = tiny_cfgs(preset)
    model = create_model(tcfg, device="cpu")
    model.net.init_weights(torch.Generator().manual_seed(0))
    model.net.eval()
    x, t = (torch.from_numpy(a) for a in inputs())
    y = x.clone()
    y[:, 2] = (y[:, 2] + 1) % S
    with torch.no_grad():
        a, b = model.apply(model.net, x, t), model.apply(model.net, y, t)
    hollow_net = preset == "hollow_synthetic"
    assert torch.allclose(a[:, 2], b[:, 2], atol=1e-6) == hollow_net


@pytest.mark.parametrize("preset", ["hollow_synthetic", "bert_synthetic", "masked_synthetic"])
def test_init_weights_follow_flax_distributions(preset):
    """`init_weights` draws each leaf from flax's initializer: per leaf, the
    std of the port's draw is within 15% of flax's (both at E=32 so every
    leaf has >= 32 entries), biases are 0 and LayerNorm scales 1."""
    cfg, tcfg = tiny_cfgs(preset, embed_dim=32, qkv_dim=32, mlp_dim=48)
    jmodel = jax_create_model(cfg)
    flax = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32),
                       jnp.full((2,), 0.5))
    net = create_model(tcfg, device="cpu").net
    net.init_weights(torch.Generator().manual_seed(0))
    got = net.state_dict()
    want = hollow_params_from_flax(jax.tree_util.tree_map(np.asarray, flax), net)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith("bias"):
            assert torch.all(g == 0) and torch.all(w == 0), k
        elif torch.all(w == 1):
            assert torch.all(g == 1), k
        else:
            ratio = float(g.std() / w.std())
            assert 0.85 < ratio < 1.15, (k, ratio)


def test_convert_rejects_missing_and_extra_leaves():
    cfg, tcfg = tiny_cfgs("hollow_synthetic")
    _, params = seeded_params(cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    net = create_model(tcfg, device="cpu").net
    inner = dict(params["BidirectionalTransformer_0"])
    embed = inner.pop("_InputEmbed_0")
    with pytest.raises(KeyError, match="no flax leaf"):
        hollow_params_from_flax({"BidirectionalTransformer_0": inner}, net)
    inner["_InputEmbed_0"] = embed
    inner["Dense_9"] = embed["Dense_0"]
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        hollow_params_from_flax({"BidirectionalTransformer_0": inner}, net)
    inner.pop("Dense_9")
    inner["_InputEmbed_0"] = {"Dense_0": {"kernel": np.zeros((2, 8), np.float32),
                                          "bias": embed["Dense_0"]["bias"]}}
    with pytest.raises(ValueError, match="shape"):
        hollow_params_from_flax({"BidirectionalTransformer_0": inner}, net)


def test_flax_defaults_kept():
    """LayerNorm epsilon 1e-6 and the tanh GELU, as flax's defaults."""
    _, tcfg = tiny_cfgs("hollow_synthetic")
    net = create_model(tcfg, device="cpu").net
    norms = [m for m in net.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)
    z = torch.linspace(-3, 3, 7)
    mlp = hollow.MLP(7, (7, 7))
    with torch.no_grad():
        for layer in (mlp.Dense_0, mlp.Dense_1):
            layer.weight.copy_(torch.eye(7))
            layer.bias.zero_()
        got = mlp(z)
    want = np.asarray(jax.nn.gelu(jnp.asarray(z.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 8), (3, 5, 8), (3, 2, 5, 8)])
def test_film_and_positional_encoding_match_jax(shape):
    """`networks/common.py`: FiLM broadcast over the middle axes, and the
    interleaved sin/cos positional table added to (B, L, d) inputs; exact
    up to float32 rounding (1e-6)."""
    from ctdd_tpu.networks.common import PositionalEncoding as JaxPE
    from ctdd_tpu.networks.common import film as jax_film
    from ctdd_tpu_torch.networks.common import PositionalEncoding, film

    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    params = rng.standard_normal((3, 16)).astype(np.float32)
    want = np.asarray(jax_film(jnp.asarray(x), jnp.asarray(params), 8))
    got = film(torch.from_numpy(x), torch.from_numpy(params), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if len(shape) == 3:
        pe = JaxPE(d_model=8, max_len=7)
        want = np.asarray(pe.apply({}, jnp.asarray(x)))
        got = PositionalEncoding(8, 7)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
