"""Port vs JAX: UNet logits after carrying the flax weights across.

Every leaf is filled with seeded normals (including the 1e-10-scaled head
conv and the zero-initialised attention projection, which would otherwise
hide the layers they feed). Float32 on both sides, different conv and
reduction orders: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import unet_params_from_flax
from ctdd_tpu_torch.networks.unet import UNetWrapper

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several workers at once beside XLA's own threads;
    torch's default of one thread per core then oversubscribes the CPU and
    the port's many small ops slow down ~3x. Imported by every port test
    file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flagship_cfgs(geometry: str):
    """(JAX cfg, port cfg) of the flagship preset at a test geometry:
    'tiny' is __graft_entry__'s tiny config ('tiny_padded' adds the maze
    presets' replication padding); 'reduced' keeps the flagship structure
    (28x28, S=256, ch_mult [1,2,2], 2 res blocks, 8 heads) at ch=16."""
    cfg = _flagship_cfg(tiny=geometry.startswith("tiny"))
    if geometry == "reduced":
        cfg.model.ch = 16
    if geometry == "tiny_padded":
        cfg.model.padding = True
        cfg.data.image_size = 7
        cfg.data.shape = [1, 7, 7]
        cfg.model.concat_dim = 49
    return cfg, Config(cfg.to_dict())


def seeded_flax_params(cfg, seed=0, scale=0.2):
    """The JAX model and its params with every leaf drawn from N(0, scale²)."""
    model = jax_create_model(cfg)
    D = cfg.model.concat_dim
    # shapes only: every leaf is redrawn below (eager flax init is slow)
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, D), jnp.int32), jnp.full((2,), 0.5)
    ))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        params,
    )
    return model, params


def port_net(tcfg, params):
    net = UNetWrapper(tcfg).eval()
    net.load_state_dict(unet_params_from_flax(params, tcfg))
    return net


@pytest.mark.parametrize("geometry", ["tiny", "tiny_padded", "reduced"])
def test_unet_logits_match_jax(geometry):
    cfg, tcfg = flagship_cfgs(geometry)
    model, params = seeded_flax_params(cfg, seed=1)
    net = port_net(tcfg, params)
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.data.S, (3, cfg.model.concat_dim)).astype(np.int32)
    t = np.array([0.01, 0.5, 1.0], np.float32)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t))
    assert out.is_contiguous()  # the fused kernel's layout
    got = out.numpy()
    assert got.shape == (3, cfg.model.concat_dim, cfg.data.S)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flagship_structure_and_attention_placement():
    """Full width: 14.0 M parameters; attn_resolutions=[48] at 28x28 gives
    stride 0, so only the middle attention exists."""
    _, tcfg = flagship_cfgs("full")
    net = UNetWrapper(tcfg)
    n = sum(p.numel() for p in net.parameters())
    assert 13.9e6 < n < 14.1e6, n
    assert len(net.unet.attns) == 1
    assert len(net.unet.res_blocks) == 3 * 2 + 2 + 3 * 3
    _, tiny = flagship_cfgs("tiny")
    assert UNetWrapper(tiny).unet.level_attn == [False, True]


def test_convert_rejects_missing_and_extra_leaves():
    cfg, tcfg = flagship_cfgs("tiny")
    _, params = seeded_flax_params(cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    unet = dict(params["UNet_0"])
    head = unet.pop("Conv_1")
    with pytest.raises(KeyError, match="no flax leaf"):
        unet_params_from_flax({"UNet_0": unet}, tcfg)
    unet["Conv_1"] = head
    unet["Conv_9"] = head
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        unet_params_from_flax({"UNet_0": unet}, tcfg)
    unet.pop("Conv_9")
    unet["Conv_1"] = {"kernel": head["kernel"][..., :1], "bias": head["bias"]}
    with pytest.raises(ValueError, match="shape"):
        unet_params_from_flax({"UNet_0": unet}, tcfg)


def _with(geometry, **model):
    cfg, tcfg = flagship_cfgs(geometry)
    for k, v in model.items():
        cfg.model[k] = v
        tcfg.model[k] = v
    return cfg, tcfg


def _logits(cfg, tcfg, params, x, t):
    """(JAX logits, port logits) on the same weights and inputs."""
    model = jax_create_model(cfg)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port_net(tcfg, params)(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return want, got


def _xt(cfg):
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.data.S, (3, cfg.model.concat_dim)).astype(np.int32)
    return x, np.array([0.01, 0.5, 1.0], np.float32)


@pytest.mark.parametrize("geometry", ["tiny", "tiny_padded", "reduced"])
def test_logistic_head_matches_jax(geometry):
    """`model_output="logistic_pars"` with the min-trick (`fix_logistic`):
    float32 logits, the file's tolerance."""
    cfg, tcfg = _with(geometry, model_output="logistic_pars", fix_logistic=True)
    _, params = seeded_flax_params(cfg, seed=1)
    want, got = _logits(cfg, tcfg, params, *_xt(cfg))
    assert got.shape == (3, cfg.model.concat_dim, cfg.data.S)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geometry", ["tiny", "reduced"])
def test_logistic_head_inputs_match_jax(geometry):
    """Without the min-trick the logits are ill-conditioned in the far bins
    (a 1e-7 change of an input moves them up to 1e6-fold), so the unfixed
    head is held at the UNet's (tanh(loc + x), log_scale), the file's
    tolerance; `logistic_bin_logits` itself is held on identical inputs in
    test_torch_logprob.py."""
    from ctdd_tpu.networks.unet import UNet as JaxUNet

    cfg, tcfg = _with(geometry, model_output="logistic_pars", fix_logistic=False)
    _, params = seeded_flax_params(cfg, seed=1)
    x, t = _xt(cfg)
    C, H, W = cfg.data.shape
    img = x.reshape(3, C, H, W).astype(np.float32)
    m = cfg.model
    jnet = JaxUNet(in_channel=C, out_channel=C, channel=m.ch,
                   channel_multiplier=tuple(m.ch_mult), n_res_blocks=m.num_res_blocks,
                   attn_resolutions=tuple(m.attn_resolutions), num_heads=m.num_heads,
                   dropout=m.dropout, model_output="logistic_pars", num_classes=cfg.data.S,
                   x_min_max=tuple(m.data_min_max), img_size=cfg.data.image_size)
    want = jnet.apply({"params": params["UNet_0"]}, jnp.asarray(img.transpose(0, 2, 3, 1)),
                      jnp.asarray(t))
    with torch.no_grad():
        got = port_net(tcfg, params).unet(torch.from_numpy(img), torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   rtol=RTOL, atol=ATOL)


# bf16: each side rounds its activations to bf16 after every layer, in
# another order, so the port sits as far from JAX's bf16 logits as JAX's bf16
# logits sit from its float32 ones (read 0.7x-1.4x of it at these
# geometries); the limit is 2x. That the port really rounds: its own bf16 vs
# float32 distance is at least a quarter of JAX's.
BF16_VS_JAX = 2.0
BF16_ROUNDS = 0.25


@pytest.mark.parametrize("head", ["logits", "logistic_pars"])
@pytest.mark.parametrize("geometry", ["tiny", "reduced"])
def test_bf16_compute_matches_jax_bf16(geometry, head):
    cfg32, tcfg32 = _with(geometry, model_output=head, fix_logistic=True)
    cfg, tcfg = _with(geometry, model_output=head, fix_logistic=True,
                      compute_dtype="bfloat16")
    _, params = seeded_flax_params(cfg, seed=1)
    x, t = _xt(cfg)
    jax16, port16 = _logits(cfg, tcfg, params, x, t)
    jax32, port32 = _logits(cfg32, tcfg32, params, x, t)
    scale = np.abs(jax32).max()
    jax_gap = np.abs(jax16 - jax32).max() / scale
    assert port16.dtype == np.float32 and np.isfinite(port16).all()
    assert np.abs(port16 - jax16).max() / scale <= BF16_VS_JAX * jax_gap
    assert np.abs(port16 - port32).max() / scale >= BF16_ROUNDS * jax_gap


def test_bf16_keeps_float32_weights_and_gradients():
    """The weights stay float32 under bf16 compute, so do their gradients
    (Adam and the EMA then run in float32, as in JAX)."""
    cfg, tcfg = _with("tiny", compute_dtype="bfloat16")
    _, params = seeded_flax_params(cfg, seed=1)
    net = port_net(tcfg, params).train()
    x, t = (torch.from_numpy(a) for a in _xt(cfg))
    net(x, t).square().mean().backward()
    assert all(p.dtype == torch.float32 and p.grad is not None
               and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in net.parameters())


def test_unknown_dtype_and_head_are_refused():
    for key, value in (("compute_dtype", "float16"), ("model_output", "mixture")):
        _, tcfg = _with("tiny", **{key: value})
        with pytest.raises(ValueError, match=value):
            UNetWrapper(tcfg)
