"""The D3PM presets of the port on the CPU: the preset copies against the
JAX presets; each built at its full width (network, parameter count, no
process where JAX has none); `D3PMLoss` through the three networks (the
tiny MNIST UNet, the Bert enum transformer, the protein net) with the flax
weights carried across and JAX's draws injected, loss and gradients against
JAX; the embeddings of the integer time at t = T-1; and tiny `train()` runs
of a preset without a process (no in-loop grid) and of one with a process
(its TauL grid fires), with resume and the fresh-pool stream.

Tolerances: the loss to rel 1e-5; each gradient leaf to 1e-4 of its largest
|g| (float32, other reduction orders; a leaf whose gradient is 0 in exact
arithmetic, such as the attention's key bias, to 1e-4 of the network's
largest |g|); logits to 1e-5 of the largest |logit|.

The integer time reaches the networks unscaled (UNet), times 1000 (Bert: up
to 5e5 rad at T=500) or halved (the protein net's Fourier features, W ~
N(0, 30^2): ~3e5 rad). At 5e5 rad one float32 ulp of a frequency moves an
argument by ~3e-2 rad, and XLA's float32 exp misses the correctly rounded
frequency table by an ulp on some entries, where the port uses the correctly
rounded table (ops/timestep.py): the Bert comparisons therefore run JAX's
embedding on the port's table, which holds the order of operations
(int t * 1000, then float32, then times the frequency).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctdd_tpu.networks.hollow as jax_hollow
from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.d3pm import diffusion as JD
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import apply_overrides, get_preset
from ctdd_tpu_torch.convert import (
    ddsm_params_from_flax, hollow_params_from_flax, unet_params_from_flax,
)
from ctdd_tpu_torch.d3pm import diffusion as TD
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.ops.timestep import timestep_embedding
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.train_step import value_and_grad
from test_d3pm_train import tiny_d3pm_cfg
from test_torch_training_loop import TINY, _states_equal, tiny_data
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

NEW = ["mnist_d3pm", "synthetic_d3pm", "protein_maze_d3pm"]
# name: (network, parameters at full width (jax.eval_shape of each preset), has a process)
FULL = {"mnist_d3pm": ("UNetWrapper", 14.02e6, True),
        "synthetic_d3pm": ("BertEnumTransformerWrapper", 0.50e6, False),
        "protein_maze_d3pm": ("ProteinScoreNetWrapper", 8.10e6, False)}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-5
GRID_LINE = "in-loop sample grids disabled: model has no CTMC process"


@pytest.mark.parametrize("name", NEW)
def test_preset_copy_matches_jax_preset(name):
    assert get_preset(name).to_dict() == jax_get_preset(name).to_dict()


@pytest.mark.parametrize("name", NEW)
def test_preset_builds_at_full_width(name):
    """The network, its parameter count (to 0.01 M), the process (none for
    the two JAX builds without one), the model's device, and finite logits
    of one forward at t = T-1."""
    cfg = get_preset(name)
    model = create_model(cfg, device="cpu")
    net, count, has_process = FULL[name]
    assert type(model.net).__name__ == net
    assert abs(sum(p.numel() for p in model.net.parameters()) - count) < 0.005e6
    assert (model.process is not None) == has_process
    assert model.device == torch.device("cpu")
    D, S = cfg.model.concat_dim, cfg.data.S
    x = torch.randint(0, S, (1, D), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model.apply(model.net.eval(), x, torch.tensor([cfg.model.num_timesteps - 1]))
    assert logits.shape == (1, D, S) and torch.isfinite(logits).all()


def test_model_device_without_a_process():
    """A model without a process takes its device from its weights."""
    cfg = Config(tiny_d3pm_cfg().to_dict())
    model = create_model(cfg, device="cpu")
    assert model.process is None and model.device == torch.device("cpu")
    assert "rate_name" not in cfg.model


def _set(cfg, dotted, value):
    *path, last = dotted.split(".")
    node = cfg
    for p in path:
        node = node[p]
    node[last] = value


def _cfgs(case):
    """(JAX cfg, port cfg, converter) of a network case, at a tiny width."""
    if case == "unet":
        cfg = jax_get_preset("mnist_d3pm")
        over = dict(s.split("=") for s in TINY)
        over.update({"model.num_pixel_vals": "8", "model.num_timesteps": "8",
                     "model.dropout": "0.0"})
        for k, v in over.items():
            _set(cfg, k, eval(v))
        convert = lambda tree, net, tcfg: unet_params_from_flax(tree, tcfg)  # noqa: E731
    elif case == "bert":
        cfg = tiny_d3pm_cfg()
        cfg.model.num_timesteps = 20
        convert = lambda tree, net, tcfg: hollow_params_from_flax(tree, net)  # noqa: E731
    else:
        cfg = jax_get_preset("protein_maze_d3pm")
        for k, v in {"data.shape": [16], "model.concat_dim": 16, "model.embed_dim": 16,
                     "model.num_timesteps": 1000}.items():
            _set(cfg, k, v)
        convert = lambda tree, net, tcfg: ddsm_params_from_flax(tree, net)  # noqa: E731
    return cfg, Config(cfg.to_dict()), convert


def _models(case, seed=1):
    """JAX's model and params (flax init, every leaf perturbed) and the port's
    model with those weights, in eval mode."""
    cfg, tcfg, convert = _cfgs(case)
    jmodel = jax_create_model(cfg)
    D = cfg.model.concat_dim
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((2, D), jnp.int32),
                                  jnp.zeros((2,), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    tmodel = create_model(tcfg, device="cpu")
    tmodel.net.load_state_dict(convert(params, tmodel.net, tcfg))
    tmodel.net.eval()
    return cfg, tcfg, jmodel, params, tmodel, convert


def _cr_freqs(half, max_positions=10000):
    """The port's frequency table: float32 exponents, exp taken in float64."""
    c = -math.log(max_positions) / (half - 1)
    return np.exp((np.arange(half, dtype=np.float32) * np.float32(c)).astype(np.float64)
                  ).astype(np.float32)


@pytest.fixture
def jax_embedding_on_the_port_table(monkeypatch):
    """JAX's `timestep_embedding` (its order: int t * scale, float32, times
    the table) on the correctly rounded table the port uses."""

    def emb(timesteps, dim, max_positions=10000):
        half = dim // 2
        args = timesteps.astype(jnp.float32)[:, None] * jnp.asarray(_cr_freqs(half))[None]
        out = jnp.concatenate([jnp.sin(args), jnp.cos(args)], axis=-1)
        return jnp.pad(out, ((0, 0), (0, 1))) if dim % 2 else out

    monkeypatch.setattr(jax_hollow, "timestep_embedding", emb)


@pytest.mark.parametrize("case", ["unet", "bert", "protein"])
def test_d3pm_loss_and_gradients_match_jax(case, jax_embedding_on_the_port_table):
    """The preset's hybrid loss (the cross-entropy) and the kl loss, with
    JAX's t and Gumbel noise injected, T-1 among the times."""
    cfg, tcfg, jmodel, params, tmodel, convert = _models(case)
    D, S, T = cfg.model.concat_dim, cfg.data.S, cfg.model.num_timesteps
    x0 = np.random.default_rng(3).integers(0, S, (3, D)).astype(np.int32)
    for loss_type in ("hybrid", "kl"):
        cfg.model.loss_type = tcfg.model.loss_type = loss_type
        jloss = JD.D3PMLoss(cfg, JD.make_diffusion(cfg.model))
        tloss = TD.D3PMLoss(tcfg, TD.make_diffusion(tcfg.model, device="cpu"))
        key = jax.random.PRNGKey(5)
        kt, kl = jax.random.split(key)
        t = np.array(jax.random.randint(kt, (3,), 0, T))
        t[0] = T - 1  # the largest embedding arguments
        gumbel = np.array(jax.random.gumbel(jax.random.split(kl)[0], (3, D, S)))
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.mean(jloss.diffusion.training_losses(
            kl, lambda x, ti: jmodel.apply(p, x, ti), jnp.asarray(x0), jnp.asarray(t)))))(params)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in tmodel.net.named_parameters()}
        tl, tg = value_and_grad(lambda q: tloss.calc_loss(
            tmodel, q, None, torch.from_numpy(x0).long(), train=False,
            t=torch.from_numpy(t).long(), gumbel=torch.from_numpy(gumbel)), p)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        want = convert(jax.tree_util.tree_map(np.asarray, jg), tmodel.net, tcfg)
        assert set(want) == set(tg)
        largest = max(v.abs().max().item() for v in want.values())
        for k, g in tg.items():
            if k.endswith("GaussianFourierProjection_0.W"):  # frozen
                assert torch.count_nonzero(g) == 0 and want[k].abs().max() == 0, k
                continue
            # the key bias: 0 in exact arithmetic (softmax ignores it)
            scale = largest if k.endswith("key.bias") else want[k].abs().max().item()
            err = (g - want[k]).abs().max().item()
            assert scale > 0 and err <= GRAD_TOL * scale, (loss_type, k, err, scale)


def test_bert_embedding_keeps_the_order_at_t_max(jax_embedding_on_the_port_table):
    """synthetic_d3pm's T=500 at its embed_dim: the port's embedding of
    t = 499 is float32(t * 1000) times the float32 table, then sin/cos,
    within 1e-6 of that reference; a reordered product (t * (1000 f)) is
    ~1e-2 away. Then the Bert net's logits at t = T-1 against JAX's."""
    cfg = get_preset("synthetic_d3pm")
    T, E = cfg.model.num_timesteps, cfg.model.embed_dim
    t = torch.tensor([T - 1, T - 2, 0])
    got = timestep_embedding(t * cfg.model.time_scale_factor, E).numpy()
    assert got.dtype == np.float32
    freqs = _cr_freqs(E // 2)
    args = (t.numpy() * 1000).astype(np.float32)[:, None] * freqs[None]
    want = np.concatenate([np.sin(args.astype(np.float64)), np.cos(args.astype(np.float64))],
                          axis=-1)
    assert np.abs(got - want).max() <= 1e-6
    reordered = t.numpy().astype(np.float32)[:, None] * (np.float32(1000) * freqs[None])
    assert np.abs(np.sin(reordered.astype(np.float64)) - want[:, :E // 2]).max() > 1e-3

    _, tcfg, jmodel, params, tmodel, _ = _models("bert")
    x = np.random.default_rng(4).integers(0, 2, (3, 8)).astype(np.int32)
    tt = np.array([499, 250, 0], np.int32)  # T of synthetic_d3pm
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(tt)))
    with torch.no_grad():
        got = tmodel.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(tt).long()).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_protein_fourier_features_at_t_max():
    """protein_maze_d3pm's T=1000: W ~ N(0, 30^2), the arguments (t/2) W 2 pi
    reach ~3e5 rad; the logits at t = 999 against JAX's."""
    cfg, _, jmodel, params, tmodel, _ = _models("protein")
    W = tmodel.net.ProteinScoreNet_0.GaussianFourierProjection_0.W
    assert (999 / 2.0) * W.abs().max().item() * 2 * math.pi > 1e5
    x = np.random.default_rng(5).integers(0, 3, (3, 16)).astype(np.int32)
    t = np.array([999, 998, 0], np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def _tiny_synthetic(tmp_path, **over):
    cfg = Config(tiny_d3pm_cfg().to_dict())
    cfg.save_location = str(tmp_path / "runs")
    cfg.saving.checkpoint_freq = 100
    for k, v in over.items():
        apply_overrides(cfg, {k.replace("__", "."): v})
    return cfg


def test_no_process_preset_trains_without_a_grid_and_resumes(tmp_path, capsys):
    """synthetic_d3pm at JAX's tiny test width: finite falling-free losses,
    JAX's line instead of a grid, no grid file; 10 steps straight equal 5
    steps and a resumed 5 bit for bit; ancestral samples in range."""
    cfg = _tiny_synthetic(tmp_path, sampler__sample_freq=5)
    full, info = train(cfg, n_iters=10, seed=2, device="cpu", log_every=5)
    assert GRID_LINE in capsys.readouterr().out
    assert all(np.isfinite(info["step_losses"])) and len(info["step_losses"]) == 10
    assert not [f for f in _listdir(info["paths"]["pngs"]) if f.startswith("samples_")]
    _, half = train(cfg, n_iters=5, seed=2, device="cpu")
    resumed, _ = train(cfg, n_iters=10, seed=2, device="cpu",
                       resume_from=half["paths"]["checkpoints"])
    _states_equal(full, resumed)
    model = info["model"]
    diffusion = TD.make_diffusion(cfg.model, device="cpu")
    s = diffusion.p_sample_loop(lambda x, t: model.apply(full.ema_params, x, t), (4, 8),
                                torch.Generator().manual_seed(0))
    assert s.shape == (4, 8) and s.min() >= 0 and s.max() < cfg.data.S


def _listdir(path):
    import os

    return os.listdir(path) if os.path.isdir(path) else []


def test_process_preset_fires_its_tau_leaping_grid(tmp_path, capsys):
    """mnist_d3pm at the tiny UNet geometry: the UNet has the
    GaussianTargetRate process, so its TauL grid fires at sample_freq with
    the D3PM-trained weights, as in JAX's loop; like JAX's, the sampler
    takes the ratio rate path for a loss outside the tauLDR family (plain
    torch: no kernel)."""
    from ctdd_tpu.sampling.samplers import get_sampler as jax_get_sampler
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    assert get_sampler(get_preset("mnist_d3pm")).rate_param == "ratio"
    assert jax_get_sampler(jax_get_preset("mnist_d3pm")).rate_param == "ratio"
    cfg = get_preset("mnist_d3pm")
    apply_overrides(cfg, {k: eval(v) for k, v in (s.split("=") for s in TINY)})
    apply_overrides(cfg, {"model.num_pixel_vals": 8, "model.num_timesteps": 8,
                          "sampler.sample_freq": 4, "sampler.num_steps": 3,
                          "data.location": tiny_data(tmp_path),
                          "save_location": str(tmp_path / "runs")})
    state, info = train(cfg, n_iters=4, device="cpu")
    assert GRID_LINE not in capsys.readouterr().out
    assert info["model"].process is not None and state.step == 4
    assert all(np.isfinite(info["step_losses"]))
    grid = np.load(f"{info['paths']['pngs']}/samples_4.npy")
    assert grid.shape == (16, 64) and grid.min() >= 0 and grid.max() < 8


def test_protein_maze_d3pm_trains_through_the_fresh_pool(tmp_path, capsys):
    """protein_maze_d3pm's `data.stream_fresh` pools: a swap at the epoch
    boundary, and JAX's no-grid line."""
    cfg = get_preset("protein_maze_d3pm")
    apply_overrides(cfg, {"model.embed_dim": 8, "data.batch_size": 4, "data.num_samples": 8,
                          "model.num_timesteps": 10, "save_location": str(tmp_path / "runs")})
    state, info = train(cfg, n_iters=3, device="cpu")
    assert GRID_LINE in capsys.readouterr().out
    assert [s[:2] for s in info["pool_swaps"]] == [(2, 1)]
    assert all(np.isfinite(info["step_losses"])) and state.step == 3
