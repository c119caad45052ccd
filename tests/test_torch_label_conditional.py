"""The label-conditional path of the port (DiT), against the JAX package
where it has a counterpart: `apply` with a bound label and classifier-free
guidance, the LabelEmbedder's forced drops, NLLOriginal (which conditions
on the label) and NLL (which drops it) with injected draws, K TauL steps
with labels and guidance on injected uniforms; and in the port alone,
`train()` of a tiny `dit_mnist` (the label table untouched under NLL, the
reference quirk, and moved under NLLOriginal), `eval --label --cfg-scale`
and `/generate` with a label.

Tiny geometry: 8x8 images, S=8, width 16, depth 2, the logits head (the
logistic head's far bins are ill-conditioned; test_torch_image_networks.py
holds it); labels lie in [0, S): the DiT's classes are its S states.
Tolerances as
test_torch_image_networks.py (logits) and test_torch_losses.py (the loss to
rtol 1e-5, each gradient leaf to 1e-4 of its largest |g|).
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.losses import losses as JL
from ctdd_tpu.networks.dit import LabelEmbedder as JaxLabelEmbedder
from ctdd_tpu.sampling import samplers as js
from ctdd_tpu_torch import eval as eval_cli
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.config.presets import apply_overrides
from ctdd_tpu_torch.convert import dit_params_from_flax
from ctdd_tpu_torch.losses import losses as TL
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.networks.dit import LabelEmbedder
from ctdd_tpu_torch.sampling import samplers as ts
from ctdd_tpu_torch.serving import SamplerService, run_http_server
from ctdd_tpu_torch.training.loop import train
from ctdd_tpu_torch.training.train_step import value_and_grad
from tests.test_torch_image_networks import flax_params, port_model
from tests.test_torch_sampler import _jax_step
from tests.test_torch_unet import one_torch_thread  # noqa: F401

TABLE = "DiT_0.LabelEmbedder_0.Embed_0.weight"
TINY = {"data.image_size": 8, "data.shape": [1, 8, 8], "data.S": 8, "model.concat_dim": 64,
        "model.hidden_dim": 16, "model.depth": 2, "model.num_heads": 2,
        "model.patch_size": 2, "model.model_output": "logits", "data.batch_size": 4,
        "sampler.num_steps": 6, "sampler.sample_freq": 0}


def tiny_cfgs(**extra):
    """(JAX cfg, port cfg) of `dit_mnist` at the tiny geometry."""
    over = {**TINY, **extra}
    cfg = jax_get_preset("dit_mnist")
    for k, v in over.items():
        *section, key = k.split(".")
        (cfg[section[0]] if section else cfg)[key] = v
    return cfg, apply_overrides(Config(jax_get_preset("dit_mnist").to_dict()), over)


def tiny_npz(path, n=32, seed=0):
    """MNIST-layout npz with states and labels in [0, 8)."""
    rng = np.random.default_rng(seed)
    np.savez(path, x_train=rng.integers(0, 8, (n, 8, 8)).astype(np.uint8),
             y_train=rng.integers(0, 8, n).astype(np.int64))
    return str(path)


@pytest.mark.parametrize("scale", [0.0, 1.0, 2.0])
def test_apply_with_a_bound_label_matches_jax(scale):
    """The handle's bound label at cfg_scale 0 (one conditional pass), 1
    (u + (c - u) = c up to rounding) and 2, the null label at S."""
    cfg, tcfg = tiny_cfgs()
    jmodel, params = flax_params(cfg)
    tmodel = port_model(tcfg, params)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 8, (4, 64)).astype(np.int32)
    t = np.array([0.02, 0.3, 0.6, 0.95], np.float32)
    label = np.array([0, 3, 7, 5])
    jbound = dataclasses.replace(jmodel, has_label=True, bound_label=jnp.asarray(label),
                                 cfg_scale=scale, null_label=8)
    want = np.asarray(jax.jit(jbound.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    tbound = ts.bind_label(tmodel, label, scale, tcfg.data.S)
    calls = []
    hook = tmodel.net.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        got = tbound.apply(tmodel.net, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    hook.remove()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert len(calls) == (2 if scale > 0 else 1)
    assert ts.bind_label(tmodel, None, scale, 8) is tmodel  # no label: cfg_scale ignored


def test_label_embedder_force_drop_ids_matches_jax():
    """Forced drops go to row num_classes; training draws the mask from the
    generator it is given (JAX: the "dropout" rng), at rate dropout_prob;
    evaluation drops nothing."""
    jemb = JaxLabelEmbedder(num_classes=8, hidden_size=16, dropout_prob=0.1)
    labels = np.array([0, 1, 2, 3, 4, 5, 6, 7])
    drop = np.array([1, 0, 0, 1, 0, 1, 0, 0])
    params = jemb.init(jax.random.PRNGKey(0), jnp.asarray(labels))
    want = np.asarray(jemb.apply(params, jnp.asarray(labels),
                                 force_drop_ids=jnp.asarray(drop)))
    emb = LabelEmbedder(8, 16, 0.1)
    emb.load_state_dict({"Embed_0.weight": torch.tensor(
        np.asarray(params["params"]["Embed_0"]["embedding"]))})
    with torch.no_grad():
        got = emb(torch.from_numpy(labels), force_drop_ids=torch.from_numpy(drop))
        np.testing.assert_array_equal(got.numpy(), want)
        table = emb.Embed_0.weight
        assert torch.equal(emb(torch.from_numpy(labels)), table[:8])
        many = torch.zeros(20000, dtype=torch.long)
        out = emb(many, train=True, generator=torch.Generator().manual_seed(1))
        dropped = (out == table[8]).all(dim=1).float().mean().item()
        assert abs(dropped - 0.1) < 0.01
        again = emb(many, train=True, generator=torch.Generator().manual_seed(1))
        assert torch.equal(out, again)
    assert emb.Embed_0.weight.shape == (9, 16)


def _grads_close(jgrads, tgrads, net, rel=1e-4):
    want = dit_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), net)
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        scale = want[k].abs().max().item()
        err = (g - want[k]).abs().max().item()
        assert err <= rel * max(scale, 1e-30), (k, err, scale)


@pytest.mark.parametrize("name", ["NLLOriginal", "NLL"])
def test_label_taking_losses_match_jax(name, monkeypatch):
    """calc_loss(label=...) with the draws patched to the same ones on both
    sides, dropout off: NLLOriginal conditions the network on the label,
    NLL drops it (its label table's gradient is 0 on both sides)."""
    cfg, tcfg = tiny_cfgs(**{"loss.name": name})
    jmodel, params = flax_params(cfg, scale=0.2)
    tmodel = port_model(tcfg, params)
    rng = np.random.default_rng(6)
    x0 = rng.integers(0, 8, (3, 64)).astype(np.int32)
    label = np.array([2, 6, 0])
    tsv = np.array([0.05, 0.3, 0.8], np.float32)
    t = torch.from_numpy(tsv)
    xt, xtl = TL.sample_xt_xtilde(torch.Generator().manual_seed(0), tmodel.transition(t),
                                  tmodel.rate(t), torch.from_numpy(x0))
    xt, xtl = xt.numpy(), xtl.numpy()
    monkeypatch.setattr(JL, "_sample_ts", lambda *a, **k: jnp.asarray(tsv))
    monkeypatch.setattr(JL, "sample_xt_xtilde", lambda *a: (jnp.asarray(xt), jnp.asarray(xtl)))
    monkeypatch.setattr(JL, "sample_xt", lambda *a: jnp.asarray(xt))
    monkeypatch.setattr(TL, "_sample_ts", lambda *a, **k: torch.from_numpy(tsv))
    monkeypatch.setattr(TL, "sample_xt_xtilde",
                        lambda *a: (torch.from_numpy(xt), torch.from_numpy(xtl)))
    monkeypatch.setattr(TL, "sample_xt", lambda *a: torch.from_numpy(xt))
    jloss, tloss = getattr(JL, name)(cfg), TL.get_loss(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.calc_loss(
        jmodel, p, jax.random.PRNGKey(0), jnp.asarray(x0), label=jnp.asarray(label),
        train=False)))(params)
    params_t = {k: v.detach().clone().requires_grad_(True)
                for k, v in tmodel.net.named_parameters()}
    tl, tg = value_and_grad(lambda p: tloss.calc_loss(
        tmodel, p, torch.Generator(), torch.from_numpy(x0), label=torch.from_numpy(label),
        train=False), params_t)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _grads_close(jg, tg, tmodel.net)
    moved = tg[TABLE].abs().max().item()
    assert (moved > 0) == (name == "NLLOriginal")
    with torch.no_grad():
        without = tloss.calc_loss(tmodel, tmodel.net, torch.Generator(),
                                  torch.from_numpy(x0), train=False)
    assert (float(without) == float(tl)) == (name == "NLL")


@pytest.mark.parametrize("name", ["NLL", "NLLOriginal"])
def test_train_tiny_dit_mnist(tmp_path, name):
    """Three steps through `train()` over a labelled dataset: under NLL (the
    preset's loss, which never passes the label: the reference quirk) the
    label table is bit-equal to its initial value in the params and the
    EMA; under NLLOriginal it moves in both."""
    _, tcfg = tiny_cfgs(**{"loss.name": name,
                           "data.location": tiny_npz(tmp_path / "tiny.npz"),
                           "save_location": str(tmp_path / "runs")})
    with torch.random.fork_rng(devices=[]):
        start = create_model(tcfg, device="cpu").net
    start.init_weights(torch.Generator().manual_seed(0))
    state, info = train(tcfg, n_iters=3, seed=0, device="cpu", log_every=1)
    assert info["model"].has_label and len(info["step_losses"]) == 3
    assert all(np.isfinite(info["step_losses"]))
    init = start.state_dict()[TABLE]
    same = [torch.equal(state.params[TABLE].detach(), init),
            torch.equal(state.ema_params[TABLE], init)]
    assert same == ([True, True] if name == "NLL" else [False, False])
    other = "DiT_0.DiTBlock_0.Dense_1.weight"
    assert not torch.equal(state.params[other].detach(), start.state_dict()[other])


@pytest.mark.parametrize("fused", [True, False])
def test_k_taul_steps_with_labels_and_cfg_match_jax(fused):
    """K TauL steps and the argmax denoise of a label-bound, guided
    (cfg_scale 1.5) model on the same x_T and uniforms: states equal."""
    cfg, tcfg = tiny_cfgs(**{"sampler.use_fused_update": fused, "sampler.num_steps": 20})
    jmodel, params = flax_params(cfg, seed=3, scale=0.15)
    tmodel = port_model(tcfg, params)
    N, S = 4, 8
    label = np.array([1, 4, 7, 2])
    jbound = dataclasses.replace(jmodel, has_label=True, bound_label=jnp.asarray(label),
                                 cfg_scale=1.5, null_label=S)
    tbound = ts.bind_label(tmodel, label, 1.5, S)
    sampler = ts.get_sampler(tcfg)
    assert sampler._fused_applicable() == fused
    jts, jhs = js._time_grid(1.0, cfg.sampler.min_t, cfg.sampler.num_steps)
    rng = np.random.default_rng(4)
    x0 = rng.integers(0, S, (N, 64)).astype(np.int32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstep = jax.jit(lambda x, t, h, u: _jax_step(cfg, jbound, params, x, t, h, u, fused))
    for k in range(5):
        u = rng.random((N, 64, S)).astype(np.float32)
        jx = jstep(jx, jts[k], jhs[k], jnp.asarray(u))
        with torch.no_grad():
            tx = sampler.step(tbound, tmodel.net, tx, float(jts[k]), float(jhs[k]),
                              u=torch.from_numpy(u))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert np.mean(tx.numpy() != x0) > 0.05  # the chain moved
    want = js._denoise_argmax(jbound, params, jx, cfg.sampler.min_t, N)
    with torch.no_grad():
        got = ts._denoise_argmax(tbound, tmodel.net, tx, tcfg.sampler.min_t, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny `dit_mnist` trained 2 steps: (port cfg, checkpoint path)."""
    tmp = tmp_path_factory.mktemp("dit")
    _, tcfg = tiny_cfgs(**{"data.location": tiny_npz(tmp / "tiny.npz"),
                           "save_location": str(tmp / "runs")})
    torch.set_num_threads(1)
    _, info = train(tcfg, n_iters=2, seed=0, device="cpu")
    return tcfg, f"{info['paths']['checkpoints']}/2.pt"


def _sets(tcfg):
    over = dict(TINY, **{"data.location": tcfg.data.location})
    return [f"{k}={v!r}".replace(" ", "") for k, v in over.items()]


def test_eval_label_and_cfg_scale_through_the_cli(trained, tmp_path, capsys):
    """`eval --label 0,5 --cfg-scale 1.5` conditions every network call: the
    saved samples equal the sampler's own on the cycled labels, two
    forwards a step and two for the denoise."""
    tcfg, ckpt = trained
    out = str(tmp_path / "s.npy")
    eval_cli.main(["--preset", "dit_mnist", "--ckpt", ckpt, "--metric", "save_samples",
                   "--samples", "3", "--label", "0,5", "--cfg-scale", "1.5", "--out", out,
                   "--device", "cpu", "--set", *_sets(tcfg)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["shape"] == [3, 64]
    model = create_model(tcfg, device="cpu")
    model.net.load_state_dict(torch.load(ckpt, weights_only=False)["ema_params"])
    model.net.eval()
    calls = []
    hook = model.net.register_forward_hook(lambda *a: calls.append(1))
    want, _ = ts.get_sampler(tcfg).sample(model, model.net, torch.Generator().manual_seed(0),
                                          3, label=[0, 5, 0], cfg_scale=1.5)
    hook.remove()
    np.testing.assert_array_equal(np.load(out), want)
    assert len(calls) == 2 * (tcfg.sampler.num_steps + 1)


def test_generate_with_a_label(trained):
    """/generate?label=...&cfg_scale=... answers 200 with samples in range;
    /healthz says the model is label-conditional."""
    tcfg, ckpt = trained
    svc = SamplerService(tcfg, ckpt, batch=2, device="cpu")
    assert svc.has_label
    server = run_http_server(svc, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["label_conditional"] is True
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/generate?n=3&label=1,6&cfg_scale=1.5",
                timeout=120) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    samples = np.asarray(body["samples"])
    assert body["shape"] == [3, 64] and samples.min() >= 0 and samples.max() < 8
    svc.warmup()  # a labelled warm-up batch
