"""Port vs JAX: the DDSM score networks (`networks/ddsm.py`) after carrying
the flax weights across (`convert.ddsm_params_from_flax`), and one train
step's loss and gradients through them.

The sudoku network runs at its real inner width (20 blocks of width 128, 8
heads; the preset's embed 256) with B=2. The protein network runs at embed
16 over L=16 positions, so the dilated convolutions' padding (up to 256)
exceeds L. Weights: flax's initial draw plus seeded normals (std 0.05) on
every leaf, so no zero bias or unit scale hides a mapping error. Eval mode,
float32 on both sides. Tolerances: logits 1e-5 of the largest |logit|; the
loss to rtol 1e-5; each gradient leaf to 1e-4 of its largest |g| (float32,
other reduction orders), and the frozen Fourier weight's gradient exactly 0
on both sides. The attention-bias projection's bias adds one constant to a
head's every logit, which the softmax cancels: its gradient is 0 in exact
arithmetic, so that leaf is scaled by the network's largest |g| instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.models.base import create_model as jax_create_model
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.convert import ddsm_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks import ddsm
from ctdd_tpu_torch.training.train_step import value_and_grad
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

REL_TOL = 1e-5
GRAD_TOL = 1e-4
PROTEIN_L, PROTEIN_EMBED = 16, 16


def cfgs(case: str):
    """(JAX cfg, port cfg, D, S) of a network case."""
    if case == "sudoku":
        cfg = jax_get_preset("sudoku")
        return cfg, Config(cfg.to_dict()), 81, 9
    S = {"protein_S3": 3, "protein_S21": 21}[case]
    cfg = jax_get_preset("protein_maze")
    with cfg.unlocked():
        cfg.data.S = S
        cfg.data.shape = [PROTEIN_L]
        cfg.model.concat_dim = PROTEIN_L
        cfg.model.embed_dim = PROTEIN_EMBED
    return cfg, Config(cfg.to_dict()), PROTEIN_L, S


def seeded_params(cfg, D, seed=1):
    model = jax_create_model(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, D), jnp.int32),
                        jnp.full((2,), 0.5))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    return model, params


def port_model(tcfg, params):
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(ddsm_params_from_flax(params, model.net))
    model.net.eval()
    return model


def inputs(D, S, n=2, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, S, (n, D)).astype(np.int32)
    return x, np.linspace(0.02, 0.9, n).astype(np.float32)


CASES = ["sudoku", "protein_S3", "protein_S21"]


@pytest.mark.parametrize("case", CASES)
def test_logits_match_jax(case):
    cfg, tcfg, D, S = cfgs(case)
    jmodel, params = seeded_params(cfg, D)
    model = port_model(tcfg, params)
    x, t = inputs(D, S)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.apply(model.net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, D, S)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


def test_sudoku_wrapper_takes_one_hot_rows():
    """(B, 729) one-hot input gives the logits of its (B, 81) cell values."""
    _, tcfg, D, S = cfgs("sudoku")
    net = create_model(tcfg, device="cpu").net.eval()
    net.init_weights(torch.Generator().manual_seed(0))
    x, t = inputs(D, S)
    cells = torch.from_numpy(x)
    one_hot = torch.nn.functional.one_hot(cells.long(), 9).reshape(2, 729)
    with torch.no_grad():
        torch.testing.assert_close(net(one_hot, torch.from_numpy(t)),
                                   net(cells, torch.from_numpy(t)), rtol=0, atol=0)


def test_encoding_is_a_buffer_and_fourier_weight_a_parameter():
    """The relation encoding moves with the module but is not a weight; the
    Fourier weight is a parameter (optimizer state, EMA, checkpoint) whose
    gradient is 0."""
    _, tcfg, D, S = cfgs("sudoku")
    net = create_model(tcfg, device="cpu").net
    params = dict(net.named_parameters())
    assert "net.GaussianFourierProjection_0.W" in params
    assert "net.encoding" not in net.state_dict()
    assert dict(net.named_buffers())["net.encoding"].shape == (81, 81, 27)
    x, t = inputs(D, S)
    out = net(torch.from_numpy(x), torch.from_numpy(t)).sum()
    _, grads = value_and_grad(lambda p: torch.func.functional_call(
        net, p, (torch.from_numpy(x), torch.from_numpy(t))).square().sum(), params)
    assert torch.count_nonzero(grads["net.GaussianFourierProjection_0.W"]) == 0
    assert torch.count_nonzero(grads["net.Dense_1.weight"]) > 0
    assert torch.isfinite(out)


@pytest.mark.parametrize("case,loss", [("sudoku", "NLLOriginal"), ("protein_S3", "CTElbo")])
def test_train_step_grads_match_jax(case, loss, monkeypatch):
    """The preset's loss with the draws (times, x_t, x̃) injected on both
    sides: the loss and every gradient leaf, the Fourier weight's 0."""
    cfg, tcfg, D, S = cfgs(case)
    for c in (cfg, tcfg):
        c.loss.name = loss
        c.loss.nll_weight = 0.5
    jmodel, params = seeded_params(cfg, D)
    tmodel = port_model(tcfg, params)
    x0, _ = inputs(D, S, n=2, seed=3)
    ts = np.array([0.01, 0.03], np.float32)
    t = torch.from_numpy(ts)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(0), tmodel.transition(t),
                                  tmodel.rate(t), torch.from_numpy(x0))
    xt, xtl = xt.numpy(), xtl.numpy()
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(ts))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(ts))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    monkeypatch.setattr(TL, "sample_xt", lambda *a: torch.from_numpy(xt))
    jloss = JL.NLLOriginal(cfg) if loss == "NLLOriginal" else JL.CTElbo(cfg)
    tloss = TL.get_loss(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), train=False)))(params)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tmodel.net.named_parameters()}
    tl, tg = value_and_grad(lambda q: tloss.calc_loss(
        tmodel, q, torch.Generator(), torch.from_numpy(x0), train=False), p)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = ddsm_params_from_flax(jax.tree_util.tree_map(np.asarray, jg), tmodel.net)
    assert set(want) == set(tg)
    fourier = [k for k in tg if k.endswith("GaussianFourierProjection_0.W")]
    assert len(fourier) == 1
    largest = max(v.abs().max().item() for v in want.values())
    for k, g in tg.items():
        scale = want[k].abs().max().item()
        err = (g - want[k]).abs().max().item()
        if k in fourier:
            assert scale == 0.0 and torch.count_nonzero(g) == 0, k
        elif k.endswith("BiasedSelfAttention_0.Dense_1.bias"):
            assert err <= GRAD_TOL * largest, (k, err, largest)
        else:
            assert scale > 0.0 and err <= GRAD_TOL * scale, (k, err, scale)


def test_init_weights_draws_flax_distributions():
    """Dense and Conv kernels lecun-normal (std 1/sqrt(fan_in)), zero biases,
    norm scales 1, the Fourier weight N(0, 30^2); seeded, so two draws from
    one seed are equal."""
    _, tcfg, _, _ = cfgs("protein_S21")
    nets = [create_model(tcfg, device="cpu").net for _ in range(2)]
    for net in nets:
        net.init_weights(torch.Generator().manual_seed(5))
    for (k, a), (_, b) in zip(nets[0].state_dict().items(), nets[1].state_dict().items()):
        assert torch.equal(a, b), k
    net = ddsm.ProteinScoreNetWrapper(Config(dict(data=dict(S=21), model=dict(embed_dim=200))))
    net.init_weights(torch.Generator().manual_seed(0))
    inner = net.ProteinScoreNet_0
    w = inner.Conv_5.weight
    assert abs(w.std().item() * (200 * 9) ** 0.5 - 1.0) < 0.02
    assert torch.count_nonzero(inner.Conv_5.bias) == 0
    assert torch.all(inner.GroupNorm_3.weight == 1.0)
    assert abs(inner.GaussianFourierProjection_0.W.std().item() / 30.0 - 1.0) < 0.25
