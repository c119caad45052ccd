"""Port vs JAX: the figure loggers (ctdd_tpu_torch/loggers against
ctdd_tpu/loggers), the writers' figures and images, the PNG encoder, and
the training loop's PNG grid and loss curve, on the CPU at the tiny
geometries of tests/test_loggers.py.

Both packages run with the same weights (the flax params carried across).
The categorical draws take JAX's noise: `jax.random.categorical(key, l)` is
argmax(l + `jax.random.gumbel(key, l.shape)`), with JAX's logger keys
(`PRNGKey(step)`, split once per t); the port's loggers draw through
`gumbel_noise`, patched here to return those draws in order. x_t must be
bit-equal; x̂0 is an argmax of logits that differ by float32 rounding, so a
near-tie may flip: at most 1e-3 of the entries.
"""

import os
import struct
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.loggers import loggers as JL
from ctdd_tpu.ops import indexing as jax_indexing
from ctdd_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from ctdd_tpu.training.state import create_train_state as jax_create_train_state
from ctdd_tpu.utils.math import safe_log as jax_safe_log
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import hollow_params_from_flax, unet_params_from_flax
from ctdd_tpu_torch.loggers import loggers as TL
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.optimizers import get_optimizer
from ctdd_tpu_torch.training.state import create_train_state
from ctdd_tpu_torch.utils import png
from ctdd_tpu_torch.utils.bookkeeping import DummyWriter, NumpyWriter
from test_torch_hollow import seeded_params
from test_torch_training_loop import tiny_cfg
from test_torch_unet import flagship_cfgs, one_torch_thread, seeded_flax_params  # noqa: F401

FLIP_FRAC = 1e-3
STEP = 7


class CaptureWriter:
    def __init__(self):
        self.figures, self.images = [], []

    def add_figure(self, tag, fig, step):
        self.figures.append((tag, step))

    def add_image(self, tag, img, step, dataformats="HW"):
        self.images.append((tag, step, np.asarray(img), dataformats))


def jax_draws(n_ts: int, shape):
    """The Gumbel noise of JAX's logger keys, one array per t."""
    key, out = jax.random.PRNGKey(STEP), []
    for _ in range(n_ts):
        key, sub = jax.random.split(key)
        out.append((sub, torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))))
    return out


def inject(monkeypatch, draws):
    """The port's loggers draw `draws` in order."""
    it = iter(g for _, g in draws)

    def gumbel_noise(generator, shape, device):
        g = next(it)
        assert tuple(g.shape) == tuple(shape)
        return g.to(device)

    monkeypatch.setattr(TL, "gumbel_noise", gumbel_noise)


def jitted(jmodel):
    """The JAX model with its forward compiled once (the loggers call
    `transition` and `apply` alone; an eager flax forward takes ~1 s)."""
    return types.SimpleNamespace(transition=jmodel.transition, apply=jax.jit(jmodel.apply))


def argmax_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.mean(got != want) <= FLIP_FRAC


@pytest.fixture(scope="module")
def images():
    """The tiny flagship of test_loggers.py in both packages, same weights:
    (jax model, params, port model, minibatch)."""
    cfg, tcfg = flagship_cfgs("tiny")
    jmodel, params = seeded_flax_params(cfg, seed=1)
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(unet_params_from_flax(params, tcfg))
    minibatch = np.random.RandomState(0).randint(0, 8, (4, 1, 8, 8))
    return cfg, tcfg, jitted(jmodel), params, model, minibatch


def bert_cfgs():
    """The tiny Bert of test_loggers.py (condition_dim 3)."""
    cfg = jax_get_preset("bert_synthetic")
    with cfg.unlocked():
        cfg.data.shape = [10]
        cfg.data.S = 4
        m = cfg.model
        m.concat_dim, m.embed_dim, m.qkv_dim, m.mlp_dim = 10, 16, 16, 32
        m.num_layers, m.num_heads, m.num_output_ffresiduals = 1, 2, 1
        m.readout, m.is_ebm, m.t_func = "resnet", False, "log_sqr"
        cfg.loss.condition_dim = 3
    return cfg, Config(cfg.to_dict())


@pytest.fixture(scope="module")
def notes():
    cfg, tcfg = bert_cfgs()
    jmodel, params = seeded_params(cfg, seed=1)
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(hollow_params_from_flax(params, model.net))
    minibatch = np.random.RandomState(0).randint(0, 4, (2, 10))
    return cfg, tcfg, jitted(jmodel), params, model, minibatch


def port_state(model, tcfg, step=STEP):
    state = create_train_state(dict(model.net.named_parameters()), get_optimizer(tcfg))
    state.step = step
    return state


def test_noise_and_denoise_with_jax_gumbel(images):
    cfg, _, jmodel, params, model, minibatch = images
    x0 = minibatch[:3].reshape(3, -1)
    for t, (key, g) in zip(TL.DENOISING_TS, jax_draws(len(TL.DENOISING_TS), (3, 64, 8))):
        want_xt, want_hat = JL._noise_and_denoise(jmodel, params, jnp.asarray(x0), t, key)
        x_t, x_hat = TL._noise_and_denoise(model, model.net, torch.from_numpy(x0), t,
                                           gumbel=g)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(want_xt))
        argmax_close(x_hat.numpy(), want_hat)


def test_denoising_images_panels_tags_and_steps(images, monkeypatch):
    """The whole logger: its panels against JAX's key schedule, and the tag
    and step JAX's logger hands its writer."""
    cfg, tcfg, jmodel, params, model, minibatch = images
    draws = jax_draws(len(TL.DENOISING_TS), (3, 64, 8))
    inject(monkeypatch, draws)
    writer = CaptureWriter()
    panels = TL.denoisingImages(state=port_state(model, tcfg), cfg=tcfg, writer=writer,
                                minibatch=minibatch, model=model)
    x0 = jnp.asarray(minibatch[:3].reshape(3, -1))
    for j, (key, _) in enumerate(draws):
        want_xt, want_hat = JL._noise_and_denoise(jmodel, params, x0, TL.DENOISING_TS[j], key)
        np.testing.assert_array_equal(panels["x_t"][j], np.asarray(want_xt))
        argmax_close(panels["x_hat"][j], want_hat)
    jwriter = CaptureWriter()
    jstate = jax_create_train_state(params, jax_get_optimizer(cfg)).replace(step=STEP)
    JL.denoisingImages(state=jstate, cfg=cfg, writer=jwriter, minibatch=minibatch,
                       model=jmodel)
    assert writer.figures == jwriter.figures == [("denoisingImages", STEP)]
    assert list(TL.DENOISING_TS) == [0.01, 0.3, 0.5, 0.6, 0.7, 0.8, 1.0]


def test_conditional_noteseq_panels_tags_and_steps(notes, monkeypatch):
    cfg, tcfg, jmodel, params, model, minibatch = notes
    cond_dim, L, S = 3, 10, 4
    draws = jax_draws(len(TL.NOTESEQ_TS), (1, L - cond_dim, S))
    inject(monkeypatch, draws)
    writer = CaptureWriter()
    panels = TL.ConditionalDenoisingNoteSeq(state=port_state(model, tcfg), cfg=tcfg,
                                            writer=writer, minibatch=minibatch, model=model)
    x = jnp.asarray(minibatch[:1].reshape(1, -1))
    cond, data = x[:, :cond_dim], x[:, cond_dim:]
    np.testing.assert_array_equal(panels["cond"], np.asarray(cond[0]))
    for j, (key, _) in enumerate(draws):  # the body of JAX's logger
        t_ones = jnp.full((1,), TL.NOTESEQ_TS[j], jnp.float32)
        rows = jax_indexing.rows(jmodel.transition(t_ones), data)
        x_t = jax.random.categorical(key, jax_safe_log(rows), axis=-1)
        logits = jmodel.apply(params, jnp.concatenate([cond, x_t], axis=1), t_ones)
        np.testing.assert_array_equal(panels["x_t"][j], np.asarray(x_t[0]))
        argmax_close(panels["x_hat"][j], jnp.argmax(logits[:, cond_dim:, :], axis=-1)[0])
    jwriter = CaptureWriter()
    jstate = jax_create_train_state(params, jax_get_optimizer(cfg)).replace(step=STEP)
    JL.ConditionalDenoisingNoteSeq(state=jstate, cfg=cfg, writer=jwriter,
                                   minibatch=minibatch, model=jmodel)
    assert writer.figures == jwriter.figures == [("ConditionalDenoisingNoteSeq", STEP)]
    assert list(TL.NOTESEQ_TS) == [0.01, 0.1, 0.3, 0.7, 1.0]


def test_registry_resolves_both_loggers():
    assert TL.get_logger("denoisingImages") is TL.denoisingImages
    assert TL.get_logger("ConditionalDenoisingNoteSeq") is TL.ConditionalDenoisingNoteSeq


def test_without_matplotlib_the_panels_go_through_add_image(images, notes, monkeypatch,
                                                            tmp_path, capsys):
    """No matplotlib: each logger hands its tiled panels to add_image and
    says so in one line; NumpyWriter writes the PNG, whose pixels read back
    through zlib equal the panels."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    writer = NumpyWriter(str(tmp_path))
    _, tcfg, _, _, model, minibatch = images
    panels = TL.denoisingImages(state=port_state(model, tcfg), cfg=tcfg, writer=writer,
                                minibatch=minibatch, model=model)
    img = png.read_png(str(tmp_path / f"denoisingImages_{STEP}.png"))
    assert img.shape == (6 * 8, 7 * 8)  # 3 images x (x_t, x̂0) rows, 7 times
    np.testing.assert_array_equal(img, TL.denoising_grid(panels, (1, 8, 8), 8))
    # image 1's x̂0 at the third time: rows 3 * 8..4 * 8, columns 2 * 8..3 * 8
    np.testing.assert_array_equal(img[24:32, 16:24],
                                  TL.to_pixels(panels["x_hat"][2, 1].reshape(8, 8), 8))
    _, tcfg, _, _, model, minibatch = notes
    panels = TL.ConditionalDenoisingNoteSeq(state=port_state(model, tcfg), cfg=tcfg,
                                            writer=writer, minibatch=minibatch, model=model)
    img = png.read_png(str(tmp_path / f"ConditionalDenoisingNoteSeq_{STEP}.png"))
    assert img.shape == (2 * 4, 5 * 10)
    seq = np.concatenate([panels["cond"], panels["x_hat"][4]])
    assert [int(np.flatnonzero(img[4:8, 40 + i])[0]) for i in range(10)] == list(3 - seq)
    lines = [s for s in capsys.readouterr().out.splitlines() if "matplotlib" in s]
    assert len(lines) == 2 and all("add_image" in s for s in lines)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (1, 1)])
def test_png_round_trips_through_zlib(shape):
    pixels = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    data = png.encode_png(pixels)
    np.testing.assert_array_equal(png.decode_png(data), pixels)
    pos = 8
    while pos < len(data):  # every chunk's CRC
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        body = data[pos + 4:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(body)
        pos += 12 + n
    with pytest.raises(TypeError):
        png.encode_png(pixels.astype(np.int32))


def test_sample_grid_figure_and_pixels():
    samples = np.random.RandomState(0).randint(0, 8, (6, 64))
    fig = TL.sample_grid_figure(samples, (1, 8, 8))
    assert fig is not None
    grid = TL.sample_grid(samples, (1, 8, 8), 8)
    assert grid.shape == (4 * 8, 2 * 8)  # 4 rows of 2, two cells empty
    np.testing.assert_array_equal(grid[8:16, 8:16], TL.to_pixels(samples[3].reshape(8, 8), 8))
    assert not grid[24:, :].any()
    rgb = TL.sample_grid(np.random.RandomState(1).randint(0, 256, (4, 48)), (3, 4, 4), 256)
    assert rgb.shape == (16, 4, 3)


def test_writers_take_figures_and_images(tmp_path):
    plt = TL.pyplot()
    fig = plt.figure()
    writer = NumpyWriter(str(tmp_path))
    writer.add_figure("a/b", fig, 3)
    writer.add_image("img", np.full((4, 5), 7, np.uint8), 9)
    plt.close(fig)
    assert (tmp_path / "a_b_3.png").read_bytes().startswith(b"\x89PNG")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "img_9.png")),
                                  np.full((4, 5), 7, np.uint8))
    with pytest.raises(ValueError):
        writer.add_image("img", np.zeros((3, 4, 4), np.uint8), 1, dataformats="CHW")
    dummy = DummyWriter()
    dummy.add_figure("x", fig, 1)
    dummy.add_image("x", np.zeros((2, 2), np.uint8), 1, dataformats="HW")


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_loop_writes_the_png_grid_and_the_loss_curve(tmp_path, monkeypatch, capsys,
                                                     with_matplotlib):
    """The in-loop grid of an image shape: samples_<step>.png beside the
    .npy, equal to its pixels; loss_curve.png where matplotlib imports, else
    one line and no curve."""
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = tiny_cfg(tmp_path, sampler__sample_freq=2, sampler__num_steps=2)
    _, info = train(cfg, n_iters=2, device="cpu", log_every=1)
    pngs, root = info["paths"]["pngs"], info["paths"]["root"]
    samples = np.load(os.path.join(pngs, "samples_2.npy"))
    np.testing.assert_array_equal(png.read_png(os.path.join(pngs, "samples_2.png")),
                                  TL.sample_grid(samples, (1, 8, 8), 8))
    assert os.path.exists(os.path.join(root, "samples_2.png"))
    curve = os.path.exists(os.path.join(root, "loss_curve.png"))
    said = "no loss_curve.png" in capsys.readouterr().out
    assert (curve, said) == ((True, False) if with_matplotlib else (False, True))
