"""Port vs JAX: DiT, U-ViT and the tauLDR U-Net after carrying the flax
weights across (`convert.dit_params_from_flax`, `uvit_params_from_flax`,
`tau_unet_params_from_flax`), at 8x8 images, S=8, width 16, depth 2.

Every leaf is filled with seeded normals (the zero-initialised adaLN
modulations, final layer and positional table would otherwise hide what
they feed). Float32 on both sides: the logits to test_torch_unet.py's
tolerance (rtol 1e-4, atol 1e-5); the logistic heads with the min-trick
(`fix_logistic`), whose unfixed form is ill-conditioned in the far bins.
bf16 compute is held statistically, as test_torch_unet.py holds the UNet's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu.networks import dit as jdit
from ctdd_tpu.networks.uvit import UViT as JaxUViT
from ctdd_tpu_torch import convert
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks import dit as tdit
from ctdd_tpu_torch.networks.uvit import UViT
from tests.test_image_networks import img_cfg
from tests.test_torch_unet import BF16_ROUNDS, BF16_VS_JAX, one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
DIT, UVIT, TAU = "GaussianDiTEMA", "GaussianUViTEMA", "GaussianTargetRateImageX0PredEMA"
CONVERT = {DIT: convert.dit_params_from_flax, UVIT: convert.uvit_params_from_flax,
           TAU: convert.tau_unet_params_from_flax}


def cfgs(name, output="logits", **model):
    """(JAX cfg, port cfg) of the JAX image tests' geometry."""
    cfg = img_cfg(name, model_output=output)
    cfg.model.fix_logistic = True
    for k, v in model.items():
        cfg.model[k] = v
    return cfg, Config(cfg.to_dict())


def flax_params(cfg, seed=1, scale=0.3):
    """The JAX model and its params (a DiT's with its LabelEmbedder), every
    leaf drawn from N(0, scale²); `seed=None` keeps flax's own init."""
    model = jax_create_model(cfg)
    D = cfg.model.concat_dim
    kw = {"label": jnp.zeros((2,), jnp.int32)} if model.has_label else {}

    def init():
        return model.init(jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32),
                          jnp.full((2,), 0.5), **kw)

    if seed is None:
        return model, jax.tree_util.tree_map(np.asarray, jax.jit(init)())
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        jax.eval_shape(init))


def port_model(tcfg, params):
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(CONVERT[tcfg.model.name](params, model.net))
    model.net.eval()
    return model


def inputs(cfg, n=3, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.data.S, (n, cfg.model.concat_dim)).astype(np.int32)
    return x, np.linspace(0.01, 0.99, n).astype(np.float32), rng.integers(0, cfg.data.S, n)


def both(cfg, tcfg, params, x, t, label=None):
    """(JAX logits, port logits) on the same weights and inputs."""
    jmodel = jax_create_model(cfg)
    jkw = {"label": jnp.asarray(label, jnp.int32)} if label is not None else {}
    want = np.asarray(jax.jit(lambda p, x, t: jmodel.apply(p, x, t, **jkw))(
        params, jnp.asarray(x), jnp.asarray(t)))
    tmodel = port_model(tcfg, params)
    with torch.no_grad():
        got = tmodel.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(t),
                           label=None if label is None else torch.from_numpy(label))
    assert got.is_contiguous()  # the fused kernel's layout
    return want, got.numpy()


@pytest.mark.parametrize("name,output,with_label,extra", [
    (DIT, "logits", True, {}),
    (DIT, "logits", False, {}),
    (DIT, "logistic_pars", True, {}),
    (UVIT, "logits", False, {}),
    (UVIT, "logits", False, {"use_checkpoint": True}),
    (TAU, "logistic_pars", False, {}),
])
def test_image_network_logits_match_jax(name, output, with_label, extra):
    cfg, tcfg = cfgs(name, output, **extra)
    _, params = flax_params(cfg)
    x, t, label = inputs(cfg)
    want, got = both(cfg, tcfg, params, x, t, label if with_label else None)
    assert got.shape == (3, cfg.model.concat_dim, cfg.data.S)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_uvit_label_token_matches_jax():
    """num_classes > 0 (the wrapper never asks for it): a label token before
    the time token, and a positional table one row longer."""
    S, C, H = 8, 1, 8
    kw = dict(img_size=H, num_states=S, patch_size=2, in_chans=C, embed_dim=16, depth=2,
              num_heads=2, mlp_ratio=2.0, num_classes=5)
    jnet = JaxUViT(**kw)
    rng = np.random.default_rng(3)
    img = rng.integers(0, S, (3, H, H, C)).astype(np.float32)
    t = np.array([0.1, 0.5, 0.9], np.float32)
    y = np.array([0, 4, 2])
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(img),
                                              jnp.asarray(t), jnp.asarray(y)))
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), shapes["params"])
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(img), jnp.asarray(t),
                                 jnp.asarray(y)))
    net = UViT(**kw).eval()
    net.load_state_dict(convert.uvit_params_from_flax(params, net))
    assert net.pos_embed.shape == (1, 2 + (H // 2) ** 2, 16)
    with torch.no_grad():
        got = net(torch.from_numpy(img.transpose(0, 3, 1, 2)), torch.from_numpy(t),
                  torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="takes labels"):
        net(torch.from_numpy(img.transpose(0, 3, 1, 2)), torch.from_numpy(t))


def test_uvit_logistic_head_reshaped_as_jax():
    """The reference wrapper reshapes the logistic head's (B, H, W, 2C)
    parameters to (B, D, S) as they are, which fits S=2 alone: ported so."""
    cfg, tcfg = cfgs(UVIT, "logistic_pars")
    for c in (cfg, tcfg):
        c.data.S = 2
    _, params = flax_params(cfg)
    x, t, _ = inputs(cfg)
    want, got = both(cfg, tcfg, params, x, t)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim,grid", [(16, 4), (512, 7), (512, 16), (64, 1)])
def test_sincos_pos_embed_equals_jax(dim, grid):
    table = tdit.get_2d_sincos_pos_embed(dim, grid)
    np.testing.assert_array_equal(table, jdit.get_2d_sincos_pos_embed(dim, grid))
    assert table.shape == (grid * grid, dim)


def test_dit_pos_embed_is_a_constant_buffer():
    _, tcfg = cfgs(DIT)
    net = create_model(tcfg, device="cpu").net.DiT_0
    want = jdit.get_2d_sincos_pos_embed(16, 4).astype(np.float32)
    np.testing.assert_array_equal(net.pos_embed.numpy(), want)
    assert "pos_embed" not in dict(net.named_parameters())
    assert not any("pos_embed" in k for k in net.state_dict())


@pytest.mark.parametrize("scale", [0.0, 1.5])
def test_forward_with_cfg_matches_jax(scale):
    cfg, tcfg = cfgs(DIT)
    jmodel, params = flax_params(cfg)
    tmodel = port_model(tcfg, params)
    x, t, _ = inputs(cfg, n=4)
    y = np.array([1, 3, 8, 8])  # the second half carries the null label
    want = jdit.forward_with_cfg(
        lambda p, x, t, y: jmodel.apply(p, x, t, label=y), params, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(y), scale)
    with torch.no_grad():
        got = tdit.forward_with_cfg(
            lambda p, x, t, y: tmodel.apply(p, x, t, label=y), tmodel.net,
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


@pytest.mark.parametrize("name,output", [(DIT, "logistic_pars"), (UVIT, "logits"),
                                         (TAU, "logistic_pars")])
def test_init_weights_draw_as_flax_initializes(name, output):
    """Port `init_weights` against flax's own init, leaf by leaf: the same
    zero and constant leaves (DiT's adaLN-Zero modulations and final layer,
    U-ViT's positional table, the biases, the norms' scales), and for every
    drawn leaf of 256 or more entries a standard deviation within 15% of
    flax's (xavier-uniform, normal(0.02), lecun-normal, NiN fan_avg)."""
    cfg, tcfg = cfgs(name, output, hidden_dim=32, ch=16)
    _, params = flax_params(cfg, seed=None)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.init_weights(torch.Generator().manual_seed(0))
    port = tmodel.net.state_dict()
    leaves = {".".join(p[:-1] + (_LEAF.get(p[-1], p[-1]),)): a for p, a in _leaves(params)}
    assert set(leaves) == set(CONVERT[name](params, tmodel.net))
    drawn = 0
    for key, want in leaves.items():
        got = port[key].numpy()
        assert got.size == want.size, key
        if np.ptp(want) == 0:
            np.testing.assert_array_equal(got, np.full_like(got, want.ravel()[0]), err_msg=key)
        elif want.size >= 256:
            drawn += 1
            assert abs(got.std() / want.std() - 1) < 0.15, (key, got.std(), want.std())
    assert drawn >= 5


def test_adaln_zero_makes_the_initial_dit_input_independent():
    """At init every DiT block's gates and the final layer are zero, so the
    network's last hidden state is 0 and the logits do not depend on x, t or
    the label; U-ViT's positional table starts at 0."""
    _, tcfg = cfgs(DIT)
    model = create_model(tcfg, device="cpu")
    model.net.init_weights(torch.Generator().manual_seed(0))
    x, t, y = (torch.from_numpy(a) for a in inputs(cfgs(DIT)[0], n=4))
    with torch.no_grad():
        out = model.apply(model.net, x, t, label=y)
    assert torch.equal(out, out[:1].expand_as(out))
    _, ucfg = cfgs(UVIT)
    uvit = create_model(ucfg, device="cpu").net
    uvit.init_weights(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(uvit.UViT_0.pos_embed) == 0


@pytest.mark.parametrize("name,output", [(DIT, "logits"), (DIT, "logistic_pars"),
                                         (UVIT, "logits"), (TAU, "logistic_pars")])
def test_bf16_compute_matches_jax_bf16(name, output):
    """As the UNet's: the port's bf16 logits sit within BF16_VS_JAX times
    JAX's own bf16-vs-float32 distance of JAX's bf16 logits, and the port
    really rounds (its own distance at least BF16_ROUNDS of JAX's)."""
    cfg32, tcfg32 = cfgs(name, output)
    cfg, tcfg = cfgs(name, output, compute_dtype="bfloat16")
    _, params = flax_params(cfg, scale=0.2)
    x, t, label = inputs(cfg)
    label = label if name == DIT else None
    jax16, port16 = both(cfg, tcfg, params, x, t, label)
    jax32, port32 = both(cfg32, tcfg32, params, x, t, label)
    scale = np.abs(jax32).max()
    jax_gap = np.abs(jax16 - jax32).max() / scale
    assert port16.dtype == np.float32 and np.isfinite(port16).all()
    assert np.abs(port16 - jax16).max() / scale <= BF16_VS_JAX * jax_gap
    assert np.abs(port16 - port32).max() / scale >= BF16_ROUNDS * jax_gap


def test_uvit_checkpointing_keeps_the_gradients():
    """`use_checkpoint` recomputes the blocks in the backward pass: the
    same loss and gradients as without it."""
    cfg, tcfg = cfgs(UVIT)
    _, params = flax_params(cfg)
    x, t, _ = (torch.from_numpy(a) for a in inputs(cfg))
    grads = []
    for flag in (False, True):
        tcfg.model.use_checkpoint = flag
        net = port_model(tcfg, params).net.train()
        net(x, t).square().mean().backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-7)


def test_convert_rejects_missing_and_extra_leaves():
    cfg, tcfg = cfgs(DIT)
    _, params = flax_params(cfg)
    net = create_model(tcfg, device="cpu").net
    dit = dict(params["DiT_0"])
    head = dit.pop("Conv_1")
    with pytest.raises(KeyError, match="no flax leaf"):
        convert.dit_params_from_flax({"DiT_0": dit}, net)
    dit["Conv_1"] = head
    dit["Conv_9"] = head
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        convert.dit_params_from_flax({"DiT_0": dit}, net)
    dit.pop("Conv_9")
    dit["Conv_1"] = {"kernel": head["kernel"][..., :1], "bias": head["bias"]}
    with pytest.raises(ValueError, match="shape"):
        convert.dit_params_from_flax({"DiT_0": dit}, net)


def test_unknown_dtype_and_head_are_refused():
    for name in (DIT, UVIT, TAU):
        _, tcfg = cfgs(name, compute_dtype="float16")
        with pytest.raises(ValueError, match="float16"):
            create_model(tcfg, device="cpu")
    for name in (DIT, UVIT):
        _, tcfg = cfgs(name, "mixture")
        with pytest.raises(ValueError, match="mixture"):
            create_model(tcfg, device="cpu")
