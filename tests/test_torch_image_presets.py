"""The five image presets of the port's slice 9 on the CPU: the preset copies
against the JAX presets; each built at its full width (parameter counts,
the sampler's rate path, one forward); the DiscreteCIFAR10 and BinMNIST
stand-ins and their npz/npy loading against the JAX package's; the CIFAR10
UNet's geometry against JAX's (3 channels, 4 scales, no attention block but
the middle one, the logistic head at C=3); a tiny `tauUnet_cifar10`-shaped
CTElboLambda value and gradient with injected draws against JAX; and a tiny
`bin_mnist_hollow` trained, sampled with LBJF and served."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.config.presets import preset_names as jax_preset_names
from ctdd_tpu.data import images as jax_images
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import PORT_ONLY, apply_overrides, get_preset, preset_names
from ctdd_tpu_torch.convert import unet_params_from_flax
from ctdd_tpu_torch.data import images
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.serving import SamplerService
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.train_step import value_and_grad
from test_torch_hollow_training import EARLIER, NEW as HOLLOW
from test_torch_maze_presets import NEW as MAZE
from test_torch_unet import one_torch_thread  # noqa: F401

NEW = ["tauUnet_cifar10", "dit_mnist", "uvit_mnist", "uvit_cifar10", "bin_mnist_hollow"]
# name: (network, parameters at full width (jax.eval_shape of each preset))
FULL = {"tauUnet_cifar10": ("UNetWrapper", 34.43e6),
        "dit_mnist": ("DiTWrapper", 34.15e6),
        "uvit_mnist": ("UViTWrapper", 53.17e6),
        "uvit_cifar10": ("UViTWrapper", 37.48e6),
        "bin_mnist_hollow": ("HollowTransformerWrapper", 4.59e6)}


def test_the_port_has_twenty_five_presets():
    """Slices 1-8's twenty and these five are all in the port (the D3PM
    slice added the last three: test_the_port_has_every_jax_preset)."""
    names = set(NEW + HOLLOW + EARLIER + MAZE + ["ebm_synthetic", "pianoroll_cond"])
    assert len(names) == 25 and names <= set(preset_names())
    assert set(preset_names()) - names - PORT_ONLY == {"mnist_d3pm", "synthetic_d3pm",
                                                       "protein_maze_d3pm"}


def test_the_port_has_every_jax_preset():
    """All 28 of the JAX package's presets, and besides them only the port's
    own (`PORT_ONLY`: SDAR's block diffusion)."""
    assert len(preset_names()) == 28 + len(PORT_ONLY)
    assert set(jax_preset_names()) ^ set(preset_names()) == PORT_ONLY


@pytest.mark.parametrize("name", NEW)
def test_preset_copy_matches_jax_preset(name):
    assert get_preset(name).to_dict() == jax_get_preset(name).to_dict()


@pytest.mark.parametrize("name", NEW)
def test_every_new_preset_builds_at_full_width(name):
    """The network and its parameter count (to 0.01 M), the sampler's rate
    path, and finite (1, D, S) logits of one forward at the preset's width
    (a DiT with a label)."""
    cfg = get_preset(name)
    model = create_model(cfg, device="cpu")
    net, count = FULL[name]
    assert type(model.net).__name__ == net
    assert model.has_label == (name == "dit_mnist")
    n = sum(p.numel() for p in model.net.parameters())
    assert abs(n - count) < 0.005e6, n
    assert get_sampler(cfg).rate_param == ("ratio" if name == "bin_mnist_hollow" else "p0t")
    D, S = cfg.model.concat_dim, cfg.data.S
    x = torch.randint(0, S, (1, D), generator=torch.Generator().manual_seed(0))
    label = torch.tensor([3]) if model.has_label else None
    with torch.no_grad():
        logits = model.apply(model.net.eval(), x, torch.tensor([0.4]), label=label)
    assert logits.shape == (1, D, S) and torch.isfinite(logits).all()


def _both(name, cfg_jax, cfg_port):
    ours = images.discrete_cifar10 if name == "DiscreteCIFAR10" else images.bin_mnist
    theirs = jax_images.discrete_cifar10 if name == "DiscreteCIFAR10" else jax_images.bin_mnist
    return ours(cfg_port), theirs(cfg_jax)


def _cfg_pair(preset, **data):
    cfg = jax_get_preset(preset)
    for k, v in data.items():
        cfg.data[k] = v
    return cfg, Config(cfg.to_dict())


@pytest.mark.parametrize("preset,name", [("uvit_cifar10", "DiscreteCIFAR10"),
                                         ("bin_mnist_hollow", "BinMNIST")])
def test_standins_equal_jax(tmp_path, preset, name):
    """No file at data.location: the seeded digits stand-in, arrays and
    labels equal to the JAX package's."""
    cfg, tcfg = _cfg_pair(preset, location=str(tmp_path / "absent.npz"), num_samples=512)
    ours, theirs = _both(name, cfg, tcfg)
    np.testing.assert_array_equal(ours.data, theirs.data)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    shape = (512, 3, 32, 32) if name == "DiscreteCIFAR10" else (512, 1, 28, 28)
    assert ours.data.shape == shape and ours.data.dtype == np.uint8
    assert ours.data.max() == (255 if name == "DiscreteCIFAR10" else 1)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC", "images"])
def test_cifar10_npz_loads_as_jax(tmp_path, layout):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 3, 32, 32)).astype(np.uint8)
    labels = rng.integers(0, 10, 6)
    path = str(tmp_path / "c.npz")
    if layout == "images":
        np.savez(path, images=imgs, labels=labels)
    else:
        np.savez(path, x_train=imgs.transpose(0, 2, 3, 1) if layout == "NHWC" else imgs,
                 y_train=labels)
    ours, theirs = _both("DiscreteCIFAR10", *_cfg_pair("uvit_cifar10", location=path))
    np.testing.assert_array_equal(ours.data, imgs)
    np.testing.assert_array_equal(ours.data, theirs.data)
    np.testing.assert_array_equal(ours.labels, theirs.labels)


@pytest.mark.parametrize("kind", ["npy", "mnist_npz"])
def test_bin_mnist_file_loads_as_jax(tmp_path, kind):
    """A binarized npy (no labels), or an MNIST npz thresholded at 127."""
    rng = np.random.default_rng(1)
    if kind == "npy":
        path = str(tmp_path / "b.npy")
        np.save(path, rng.integers(0, 2, (5, 784)).astype(np.uint8))
    else:
        path = str(tmp_path / "m.npz")
        np.savez(path, x_train=rng.integers(0, 256, (5, 28, 28)).astype(np.uint8),
                 y_train=np.arange(5))
    ours, theirs = _both("BinMNIST", *_cfg_pair("bin_mnist_hollow", location=path))
    assert ours.data.shape == (5, 1, 28, 28)
    np.testing.assert_array_equal(ours.data, theirs.data)
    assert (ours.labels is None) == (theirs.labels is None) == (kind == "npy")


def test_cifar10_unet_geometry_matches_jax():
    """`tauUnet_cifar10` runs the flagship's UNet at 3 channels and 4 scales:
    attn_resolutions=[64] at 32x32 gives the stride 32 // 64 = 0, so only
    the middle attention exists (the reference quirk, ported); the logistic
    head has 2·3 channels. Every flax leaf maps onto the port at its shape."""
    cfg = jax_get_preset("tauUnet_cifar10")
    model = jax_create_model(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3072), jnp.int32), jnp.full((2,), 0.5)))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    tcfg = get_preset("tauUnet_cifar10")
    sd = unet_params_from_flax(zeros, tcfg)
    net = create_model(tcfg, device="cpu").net
    assert set(sd) == set(net.state_dict())
    unet = net.unet
    assert unet.level_attn == [False, False, False, False] and len(unet.attns) == 1
    assert len(unet.downs) == 3 and len(unet.ups) == 3
    assert unet.conv_0.in_channels == 3 and unet.conv_1.out_channels == 6
    assert unet.model_output == "logistic_pars"


def test_tiny_cifar10_ctelbo_lambda_matches_jax(monkeypatch):
    """A `tauUnet_cifar10`-shaped model at 8x8x3, S=8, ch=8 with its four
    scales: CTElboLambda at n_iter = n_iters / 4 (both terms count), value
    and gradient with the draws injected on both sides, dropout off."""
    over = {"image_size": 8, "shape": [3, 8, 8], "S": 8}
    model_over = {"ch": 8, "concat_dim": 192, "data_min_max": [0, 7], "num_heads": 2,
                  "fix_logistic": True}
    cfg = jax_get_preset("tauUnet_cifar10")
    for k, v in over.items():
        cfg.data[k] = v
    for k, v in model_over.items():
        cfg.model[k] = v
    tcfg = Config(cfg.to_dict())
    jmodel = jax_create_model(cfg)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((2, 192), jnp.int32),
                                           jnp.full((2,), 0.5))))
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(unet_params_from_flax(params, tcfg))
    tmodel.net.eval()
    x0 = rng.integers(0, 8, (3, 192)).astype(np.int32)
    tsv = np.array([0.01, 0.02, 0.03], np.float32)
    t = torch.from_numpy(tsv)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(0), tmodel.transition(t),
                                  tmodel.rate(t), torch.from_numpy(x0))
    xt, xtl = xt.numpy(), xtl.numpy()
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(tsv))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(tsv))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    n_iter = cfg.training.n_iters // 4
    jloss, tloss = JL.CTElboLambda(cfg), TL.get_loss(tcfg)
    assert type(tloss).__name__ == "CTElboLambda"
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), n_iter=n_iter, train=False)))(params)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tmodel.net.named_parameters()}
    tl, tg = value_and_grad(lambda q: tloss.calc_loss(
        tmodel, q, torch.Generator(), torch.from_numpy(x0), n_iter=n_iter, train=False), p)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = unet_params_from_flax(jax.tree_util.tree_map(np.asarray, jg), tcfg)
    for k, g in tg.items():
        scale = want[k].abs().max().item()
        assert (g - want[k]).abs().max().item() <= 1e-4 * max(scale, 1e-30), k


def test_tiny_bin_mnist_hollow_trains_samples_and_serves(tmp_path):
    """`bin_mnist_hollow` at a tiny width over a binarized npy: train() 3
    steps (CatRM), LBJF on the ratio path, the checkpoint served."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "bin.npy")
    np.save(path, rng.integers(0, 2, (32, 64)).astype(np.uint8))
    cfg = apply_overrides(get_preset("bin_mnist_hollow"), {
        "data.location": path, "data.image_size": 8, "data.shape": [1, 8, 8],
        "model.concat_dim": 64, "model.embed_dim": 16, "model.qkv_dim": 16,
        "model.num_layers": 1, "model.num_heads": 2, "model.mlp_dim": 16,
        "data.batch_size": 4, "sampler.num_steps": 4, "sampler.sample_freq": 0,
        "save_location": str(tmp_path / "runs")})
    state, info = train(cfg, n_iters=3, seed=0, device="cpu")
    assert len(info["step_losses"]) == 3 and np.isfinite(info["step_losses"]).all()
    model = info["model"]
    samples, _ = get_sampler(cfg).sample(model, state.ema_params,
                                         torch.Generator().manual_seed(0), 3)
    assert samples.shape == (3, 64) and set(np.unique(samples)) <= {0, 1}
    svc = SamplerService(cfg, f"{info['paths']['checkpoints']}/3.pt", batch=2, device="cpu")
    out = svc.generate(3)
    assert out.shape == (3, 64) and set(np.unique(out)) <= {0, 1}
