"""Port vs JAX: the training loop's fresh-pool stream (`data.stream_fresh`).

Both packages' `train()` run a tiny residual MLP over the maze and sudoku
pools (16 boards, batch 4: 4 steps an epoch) across two pool boundaries:
synchronously with `stream_refresh_period` 1 and asynchronously with period
2. Each side's `regenerate` is wrapped with `unittest.mock` to record the
epochs it is asked for, and each side's device-data step with a recorder of
the pool it trains on: the epochs, their order and the pool at every step
are equal. A resume from a mid-run checkpoint replays the uninterrupted
run's pools. Exact comparisons throughout.
"""

import hashlib
from unittest import mock

import numpy as np
import pytest
import torch

import ctdd_tpu.training.train_step as jax_train_step
from ctdd_tpu.config.presets import get_preset as jax_get_preset
from ctdd_tpu.data import maze as jax_maze
from ctdd_tpu.data import sudoku as jax_sudoku
from ctdd_tpu.parallel.mesh import make_mesh
from ctdd_tpu.training.loop import train as jax_train
from ctdd_tpu_torch.config.base import Config
from ctdd_tpu_torch.data import maze, sudoku
from ctdd_tpu_torch.training import loop as port_loop
from ctdd_tpu_torch.training.loop import train
from test_torch_unet import one_torch_thread  # noqa: F401  (autouse fixture)

POOLS = {"Maze3S": (maze.MazePoolDataset, jax_maze.MazePoolDataset, 3, 225),
         "SudokuDataset": (sudoku.SudokuPoolDataset, jax_sudoku.SudokuPoolDataset, 9, 81)}


def cfgs(tmp_path, dataset: str, period: int):
    """(JAX cfg, port cfg): the MLP preset at a tiny width over a pool of 16
    boards, batch 4, a fresh pool every `period` epochs."""
    _, _, S, D = POOLS[dataset]
    jcfg = jax_get_preset("mlp_synthetic")
    with jcfg.unlocked():
        jcfg.data.name, jcfg.data.S, jcfg.data.shape = dataset, S, [D]
        jcfg.data.num_samples, jcfg.data.batch_size, jcfg.data.seed = 16, 4, 3
        jcfg.data.random_transform = True
        jcfg.data.stream_fresh, jcfg.data.stream_refresh_period = True, period
        jcfg.model.d_model = jcfg.model.hidden_dim = jcfg.model.temb_dim = 8
        jcfg.model.num_layers, jcfg.model.concat_dim = 1, D
        jcfg.sampler.sample_freq = 0
        jcfg.save_location = str(tmp_path / "jax")
    cfg = Config(jcfg.to_dict())
    cfg.save_location = str(tmp_path / "port")
    return jcfg, cfg


def digest(pool) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(pool)).tobytes()).hexdigest()


def recording(seen, make_real=None):
    """A stand-in for the loop's device-data step builder that records the
    pool of every step; with `make_real`, the real step runs too."""
    def make(*a, **k):
        real = make_real(*a, **k) if make_real else None

        def step(state, data, *rest):
            seen.append(digest(data))
            return real(state, data, *rest) if real else (state, 0.0)
        return step
    return make


@pytest.mark.parametrize("dataset,period,n_iters,epochs", [
    ("Maze3S", 1, 10, [1, 2]),          # sync, swaps at steps 4 and 8
    ("SudokuDataset", 2, 17, [2, 4]),   # async, swaps at steps 8 and 16
    ("Maze3S", 2, 15, [2]),             # async; the run ends before step 16
])
def test_pools_match_jax(tmp_path, monkeypatch, dataset, period, n_iters, epochs):
    port_cls, jax_cls, _, _ = POOLS[dataset]
    jcfg, cfg = cfgs(tmp_path, dataset, period)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_train_step, "make_device_data_step", recording(seen["jax"]))
    monkeypatch.setattr(port_loop, "make_device_data_train_step", recording(seen["port"]))
    with mock.patch.object(jax_cls, "regenerate", autospec=True,
                           side_effect=jax_cls.regenerate) as jax_regen:
        jax_train(jcfg, n_iters=n_iters, seed=4, writer_kind="numpy", mesh=make_mesh(1),
                  log_every=1000)
    with mock.patch.object(port_cls, "regenerate", autospec=True,
                           side_effect=port_cls.regenerate) as port_regen:
        _, info = train(cfg, n_iters=n_iters, seed=4, device="cpu", log_every=1000)
    assert [c.args[1] for c in jax_regen.call_args_list] == epochs
    assert [c.args[1] for c in port_regen.call_args_list] == epochs
    assert len(seen["port"]) == len(seen["jax"]) == n_iters
    assert seen["port"] == seen["jax"]
    steps_per_pool = 4 * period
    assert [s[:2] for s in info["pool_swaps"]] == [(e * 4, e) for e in epochs]
    assert len(set(seen["port"][::steps_per_pool])) == len(epochs) + 1


def test_resume_replays_the_pools(tmp_path, monkeypatch):
    """10 real steps, then a fresh train() resumed from step 10's checkpoint
    to 17: the pools of steps 10-16 are the uninterrupted run's, and so is
    the final state."""
    _, cfg = cfgs(tmp_path, "SudokuDataset", 2)
    cfg.saving.checkpoint_freq = 10
    real = port_loop.make_device_data_train_step
    whole, first, second = [], [], []
    monkeypatch.setattr(port_loop, "make_device_data_train_step", recording(whole, real))
    state, _ = train(cfg, n_iters=17, seed=4, device="cpu", log_every=1000)
    monkeypatch.setattr(port_loop, "make_device_data_train_step", recording(first, real))
    _, info = train(cfg, n_iters=10, seed=4, device="cpu", log_every=1000)
    monkeypatch.setattr(port_loop, "make_device_data_train_step", recording(second, real))
    resumed, info2 = train(cfg, n_iters=17, seed=4, device="cpu", log_every=1000,
                           resume_from=info["paths"]["checkpoints"])
    assert first + second == whole
    assert [s[:2] for s in info2["pool_swaps"]] == [(10, 2), (16, 4)]
    for k in state.params:
        assert torch.equal(state.params[k], resumed.params[k]), k


def test_a_failed_generation_raises_at_the_swap(tmp_path, monkeypatch):
    """An error in the background generator surfaces in train(), and no
    thread is left behind."""
    _, cfg = cfgs(tmp_path, "SudokuDataset", 2)

    def broken(self, epoch):
        raise RuntimeError(f"generator failed at epoch {epoch}")

    monkeypatch.setattr(sudoku.SudokuPoolDataset, "regenerate", broken)
    with pytest.raises(RuntimeError, match="generator failed at epoch 2"):
        train(cfg, n_iters=12, seed=4, device="cpu", log_every=1000)
