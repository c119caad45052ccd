"""The maze, sudoku and protein presets in the port on the CPU: the preset
copies against the JAX presets, every preset building a model and a sampler
at its full width, and `sudoku`, `protein_maze`, `hollow_protein` and
`tauUnet_maze` (whose Maze3S pool is now ported) trained a few steps
through `train()` over their pools (the fresh-pool stream on), sampled and
served from the trainer's checkpoint, and scored by the eval CLI."""

import json

import numpy as np
import pytest
import torch

from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu_torch import eval as eval_cli
from ctdd_tpu_torch.config.presets import get_preset, preset_names
from ctdd_tpu_torch.models.base import create_model
from ctdd_tpu_torch.sampling.samplers import get_sampler
from ctdd_tpu_torch.serving import SamplerService
from ctdd_tpu_torch.training.loop import train
from test_torch_hollow_training import EARLIER, NEW as HOLLOW
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

NEW = ["hollow_maze", "bert_maze", "bert_mazemasked", "hollow_maze_distr", "protein_maze",
       "hollow_protein", "sudoku"]
NETWORKS = {"hollow_maze": "HollowTransformerWrapper",
            "bert_maze": "BertEnumTransformerWrapper",
            "bert_mazemasked": "EnumerativeTransformerWrapper",
            "hollow_maze_distr": "HollowTransformerWrapper",
            "protein_maze": "ProteinScoreNetWrapper",
            "hollow_protein": "HollowTransformerWrapper",
            "sudoku": "SudokuScoreNetWrapper"}


def test_the_port_has_eighteen_presets():
    """The eighteen presets of slices 1-7 stay (later slices add theirs)."""
    assert len(set(NEW + HOLLOW + EARLIER)) == 18
    assert set(NEW + HOLLOW + EARLIER) <= set(preset_names())


@pytest.mark.parametrize("name", NEW)
def test_preset_copy_matches_jax_preset(name):
    assert get_preset(name).to_dict() == jax_get_preset(name).to_dict()


@pytest.mark.parametrize("name", NEW)
def test_every_new_preset_builds_a_model_and_a_sampler(name):
    """At the preset's full width on the CPU; the hollow and masked presets
    sample on the ratio path, the tauLDR losses on the p0t path, and the
    network's logits have the preset's (D, S)."""
    cfg = get_preset(name)
    model = create_model(cfg, device="cpu")
    sampler = get_sampler(cfg)
    assert type(model.net).__name__ == NETWORKS[name]
    ratio = cfg.loss.name not in ("CTElbo", "NLLOriginal")
    assert sampler.rate_param == ("ratio" if ratio else "p0t")
    D, S = cfg.model.concat_dim, cfg.data.S
    x = torch.randint(0, S, (2, D), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model.apply(model.net.eval(), x, torch.tensor([0.1, 0.7]))
    assert logits.shape == (2, D, S) and torch.isfinite(logits).all()


def tiny(name, tmp_path):
    """The preset over a small pool, at a narrow width where it has one."""
    cfg = get_preset(name)
    cfg.data.num_samples, cfg.data.batch_size = 16, 4
    cfg.data.location = str(tmp_path / "absent.npy")  # the protein stand-in
    cfg.save_location = str(tmp_path / "runs")
    cfg.sampler.num_steps, cfg.sampler.sample_freq = 4, 0
    cfg.sampler.num_corrector_steps = 0
    if name == "protein_maze":
        cfg.model.embed_dim = 16
    if name == "hollow_protein":
        cfg.model.embed_dim = cfg.model.qkv_dim = 16
        cfg.model.mlp_dim = 32
    return cfg


@pytest.mark.parametrize("name,metric", [("sudoku", "sudoku_acc"),
                                         ("protein_maze", "maze_acc"),
                                         ("hollow_protein", None),
                                         ("tauUnet_maze", "maze_acc")])
def test_train_then_sample_serve_and_score(name, metric, tmp_path, capsys):
    """Six steps through train() (a fresh pool at step 4 where the preset
    streams), a finite loss every step, the weights moved; samples of the
    EMA weights; the trainer's checkpoint served; the eval CLI's accuracy."""
    cfg = tiny(name, tmp_path)
    cfg.data.stream_refresh_period = 1
    state, info = train(cfg, n_iters=6, seed=1, device="cpu", log_every=3)
    losses = np.asarray(info["step_losses"])
    assert losses.shape == (6,) and np.isfinite(losses).all() and losses.max() < 1e9
    swaps = [s[:2] for s in info["pool_swaps"]]
    assert swaps == ([] if name == "hollow_protein" else [(4, 1)])
    start = create_model(cfg, device="cpu").net
    start.init_weights(torch.Generator().manual_seed(1))
    moved = [k for k, v in start.named_parameters() if not torch.equal(v, state.params[k])]
    assert moved and not any(k.endswith("GaussianFourierProjection_0.W") for k in moved)

    D, S = cfg.model.concat_dim, cfg.data.S
    samples, _ = get_sampler(cfg).sample(info["model"], state.ema_params,
                                         torch.Generator().manual_seed(0), 3)
    assert samples.shape == (3, D) and samples.min() >= 0 and samples.max() < S
    ckpt = f"{info['paths']['checkpoints']}/6.pt"
    out = SamplerService(cfg, ckpt, batch=2, device="cpu").generate(3)
    assert out.shape == (3, D) and out.min() >= 0 and out.max() < S
    if metric:
        sets = ["data.num_samples=16", "sampler.num_steps=3", "sampler.num_corrector_steps=0"]
        if name == "protein_maze":
            sets.append("model.embed_dim=16")
        result = eval_cli.main(["--preset", name, "--ckpt", ckpt, "--metric", metric,
                                "--samples", "4", "--device", "cpu", "--set", *sets])
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert last["metric"] == metric and 0.0 <= last["value"] <= 1.0
        assert result["value"] == last["value"]
